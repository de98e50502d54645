"""Command line of the port: ``python -m mlcomp_tpu_torch.cli <command>``.

Every command of the JAX CLI, with its flag names, plus ``--device`` where
a command runs tasks or a model (default ``cuda``: without a card they fail
rather than run on the CPU; ``--device cpu`` runs the kernels' plain
versions):

- ``validate <yaml>``: parse a DAG and print its tasks in order.
- ``dag <yaml>``: run a DAG locally (supervisor and in-process workers,
  ``scheduler/local.run_dag_local``).
- ``submit``, ``status``, ``stop``, ``restart``: the task store's queue
  (``db/store.py``; the sqlite schema is the JAX package's, so either CLI
  reads a store the other wrote).
- ``supervisor``, ``worker``, ``pool``: the daemons that run a submitted
  DAG; a worker runs each task in an isolated child pinned to its chips
  (``CUDA_VISIBLE_DEVICES``) unless ``--in-process``.
- ``tokenize``: a text corpus to the ``token_bin`` dataset's ``.bin``.
- ``report``: the report server (``report/server.py``).
- ``serve``: an LM over HTTP; ``--ckpt`` names a training checkpoint
  directory or a ``.npz`` params tree (``io.weights.save_npz``),
  ``--storage-task PROJECT/DAG/TASK`` a train task's checkpoints in model
  storage.
- ``fleet``: serve replicas behind the prefix-affinity router
  (``fleet/``), monolithic or phase-split (``--phase-split P:D``).
- ``average DIR[:STEP]... --out DIR``: the weight-space average of
  checkpoints (``io.checkpoint.average_checkpoints``).
"""

from __future__ import annotations

import argparse
import json
import sys


def _steps_per_dispatch(value: str):
    """``--steps-per-dispatch``: a positive int, or ``adaptive``."""
    if value.strip().lower() == "adaptive":
        return "adaptive"
    try:
        k = int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected an int or 'adaptive', got {value!r}")
    if k < 1:
        raise argparse.ArgumentTypeError(f"steps per dispatch must be >= 1, got {k}")
    return k


def _cmd_validate(args: argparse.Namespace) -> int:
    from mlcomp_tpu_torch.dag import parse_dag, topo_sort

    dag = parse_dag(args.config)
    order = topo_sort(dag.tasks)
    print(f"dag {dag.name!r} (project {dag.project!r}): {len(dag.tasks)} tasks")
    for t in order:
        deps = f" <- {list(t.depends)}" if t.depends else ""
        print(f"  {t.name} [{t.executor}/{t.stage}] chips={t.resources.chips}{deps}")
    return 0


def _cmd_submit(args: argparse.Namespace) -> int:
    from pathlib import Path

    from mlcomp_tpu_torch.dag import parse_dag
    from mlcomp_tpu_torch.db.store import Store
    from mlcomp_tpu_torch.io.sync import inject_code_sync

    dag = parse_dag(args.config)
    dag = inject_code_sync(dag, base_dir=Path(args.config).parent)
    store = Store(args.db)
    dag_id = store.submit_dag(dag)
    store.close()
    print(json.dumps({"dag_id": dag_id, "name": dag.name, "tasks": len(dag.tasks)}))
    return 0


def _cmd_status(args: argparse.Namespace) -> int:
    from mlcomp_tpu_torch.db.store import Store

    store = Store(args.db)
    try:
        if args.dag is not None:
            for r in store.task_rows(args.dag):
                line = f"  {r['id']:>4} {r['name']:<28} {r['status']:<12}"
                if r["worker"]:
                    line += f" worker={r['worker']}"
                if r["error"]:
                    line += f" error={r['error'].splitlines()[-1][:60]}"
                print(line)
            return 0
        for d in store.list_dags():
            counts: dict = {}
            for st in store.task_statuses(d["id"]).values():
                counts[st.value] = counts.get(st.value, 0) + 1
            print(f"{d['id']:>4} {d['name']:<20} {d['project']:<12} {d['status']:<12} {counts}")
        return 0
    finally:
        store.close()


def _dag_or_task(args: argparse.Namespace) -> bool:
    """stop/restart take exactly one of a DAG id or ``--task``."""
    if (args.dag is None) == (args.task is None):
        print("error: give either a DAG id or --task TASK_ID", file=sys.stderr)
        return False
    return True


def _cmd_stop(args: argparse.Namespace) -> int:
    from mlcomp_tpu_torch.db.store import Store

    if not _dag_or_task(args):
        return 2
    store = Store(args.db)
    if args.task is not None:
        out = {"task_id": args.task, "stopped": store.stop_task(args.task)}
    else:
        out = {"dag_id": args.dag, "stopped_tasks": store.stop_dag(args.dag)}
    store.close()
    print(json.dumps(out))
    return 0


def _cmd_restart(args: argparse.Namespace) -> int:
    from mlcomp_tpu_torch.db.store import Store

    if not _dag_or_task(args):
        return 2
    store = Store(args.db)
    if args.task is not None:
        out = {"task_id": args.task, "reset_tasks": store.restart_task(args.task)}
    else:
        out = {"dag_id": args.dag, "reset_tasks": store.restart_dag(args.dag)}
    store.close()
    print(json.dumps(out))
    return 0


def _cmd_supervisor(args: argparse.Namespace) -> int:
    from mlcomp_tpu_torch.db.store import Store
    from mlcomp_tpu_torch.scheduler.supervisor import Supervisor

    notifiers = None
    if args.notify:
        import yaml

        notifiers = [yaml.safe_load(n) for n in args.notify]
    Supervisor(Store(args.db), notifiers=notifiers).run_forever(poll_interval=args.poll)
    return 0


def _cmd_worker(args: argparse.Namespace) -> int:
    import signal
    import threading

    from mlcomp_tpu_torch.db.store import Store
    from mlcomp_tpu_torch.scheduler.worker import Worker

    w = Worker(Store(args.db), name=args.name, chips=args.chips, workdir=args.workdir,
               isolate=not args.in_process, max_tasks=args.max_tasks, device=args.device)
    # SIGTERM drains: running tasks finish, nothing new is claimed, then
    # the loop returns (what `pool` sends on stop)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *a: stop.set())
    w.run_forever(poll_interval=args.poll, stop_event=stop)
    return 0


def _cmd_pool(args: argparse.Namespace) -> int:
    from mlcomp_tpu_torch.db.store import Store
    from mlcomp_tpu_torch.scheduler.pool import WorkerPool, parse_inventory

    if bool(args.inventory) == bool(args.hosts):
        print("error: pass exactly one of --inventory / --hosts", file=sys.stderr)
        return 2
    if args.inventory:
        with open(args.inventory) as f:
            hosts = parse_inventory(f.read(), default_chips=args.chips)
    else:
        hosts = parse_inventory("\n".join(h.strip() for h in args.hosts.split(",")),
                                default_chips=args.chips)
    pool = WorkerPool(Store(args.db), hosts, db_path=args.db, base_workdir=args.workdir,
                      launch_template=args.launch, kill_template=args.kill,
                      heartbeat_timeout_s=args.heartbeat_timeout)
    pool.run_forever(poll_interval=args.poll)
    return 0


def _cmd_tokenize(args: argparse.Namespace) -> int:
    """Text corpus -> flat token ``.bin`` (+ ``.json`` sidecar) for the
    ``token_bin`` dataset.  Byte-level by default (ids 0-255, EOS 256
    between documents); ``--hf-tokenizer DIR`` reads a local pretrained
    tokenizer directory through ``transformers``."""
    from pathlib import Path

    import numpy as np

    out = Path(args.output)
    sidecar = out.with_suffix(out.suffix + ".json")

    def _keep(q: Path, root) -> bool:
        # never re-read our own output; inside a scanned directory skip
        # hidden trees, judged only below the root the user named
        if q.resolve() in (out.resolve(), sidecar.resolve()):
            return False
        rel = q.relative_to(root).parts if root is not None else ()
        return not any(part.startswith(".") for part in rel)

    paths: list = []
    for src in args.inputs:
        p = Path(src)
        if p.is_dir():
            paths.extend(sorted(q for q in p.rglob("*") if q.is_file() and _keep(q, p)))
        elif p.exists():
            if _keep(p, None):
                paths.append(p)
        else:
            print(f"error: no such input {src!r}", file=sys.stderr)
            return 2
    if not paths:
        print("error: no input files", file=sys.stderr)
        return 2

    tok = None
    if args.hf_tokenizer:
        try:
            from transformers import AutoTokenizer
        except ImportError:
            print("error: --hf-tokenizer needs the transformers package, which is not "
                  "installed", file=sys.stderr)
            return 2
        tok = AutoTokenizer.from_pretrained(args.hf_tokenizer, local_files_only=True)
        eos_id = tok.eos_token_id
        if eos_id is None:
            # the first id past the base vocabulary and any added tokens
            eos_id = len(tok)
        vocab_size = max(len(tok), eos_id + 1)
    else:
        eos_id, vocab_size = 256, 257
    dtype = np.uint16 if vocab_size <= 65536 else np.uint32

    total = 0
    with open(out, "wb") as f:
        for p in paths:
            text = p.read_text(encoding="utf-8", errors="replace")
            ids = (tok.encode(text, add_special_tokens=False) if tok is not None
                   else list(text.encode("utf-8")))
            ids.append(eos_id)
            np.asarray(ids, dtype=dtype).tofile(f)
            total += len(ids)
    meta = {"dtype": np.dtype(dtype).name, "vocab_size": int(vocab_size), "eos_id": int(eos_id),
            "tokens": int(total), "documents": len(paths),
            "tokenizer": args.hf_tokenizer or "byte"}
    sidecar.write_text(json.dumps(meta))
    print(json.dumps(meta))
    return 0


def _cmd_report(args: argparse.Namespace) -> int:
    from mlcomp_tpu_torch.report.server import serve

    serve(db_path=args.db, host=args.host, port=args.port)
    return 0


def _cmd_dag(args: argparse.Namespace) -> int:
    from mlcomp_tpu_torch.scheduler.local import run_dag_local

    results = run_dag_local(
        args.config, workers=args.workers, db_path=args.db, workdir=args.workdir,
        device=args.device,
    )
    bad = {n: s.value for n, s in results.items() if s.value != "success"}
    print(json.dumps({n: s.value for n, s in results.items()}, indent=2))
    return 1 if bad else 0


def _cmd_average(args: argparse.Namespace) -> int:
    from mlcomp_tpu_torch.io.checkpoint import average_checkpoints

    weights = [float(w) for w in args.weights.split(",")] if args.weights else None
    path = average_checkpoints(args.sources, args.out, weights=weights)
    print(json.dumps({"averaged": len(args.sources), "out": path}))
    return 0


def _cmd_serve(args: argparse.Namespace) -> int:
    import yaml

    from mlcomp_tpu_torch.serve import load_service, resolve_storage_ckpt, serve_http

    with open(args.model) as f:
        doc = yaml.safe_load(f)
    # a bare model mapping, or any YAML with a top-level ``model:`` section
    model_cfg = doc.get("model", doc) if isinstance(doc, dict) else doc
    if args.kv_quant:
        model_cfg = {**model_cfg, "kv_quant": True}
    if not args.ckpt and not args.storage_task:
        # serving random init silently would look healthy and emit junk
        print("error: pass --ckpt or --storage-task (a checkpoint to serve)", file=sys.stderr)
        return 2
    ckpt = args.ckpt
    if not ckpt:
        parts = args.storage_task.split("/")
        if len(parts) != 3:
            print(f"error: --storage-task must be PROJECT/DAG/TASK, got {args.storage_task!r}",
                  file=sys.stderr)
            return 2
        ckpt = resolve_storage_ckpt(*parts)
    mesh_cfg = None
    if args.mesh:
        try:
            mesh_cfg = {k.strip(): int(v) for k, v in (kv.split("=") for kv in args.mesh.split(","))}
        except ValueError:
            print(f"error: --mesh expects AXIS=N[,AXIS=N...], got {args.mesh!r}", file=sys.stderr)
            return 2
    dist = None
    if args.distributed:
        # a serve gang: join the process group FIRST (the mesh spans every
        # rank), then open the boundary channel.  Every rank runs the same
        # command line; rank 0 fronts the gang, the others follow
        if not mesh_cfg:
            print("error: --distributed needs --mesh (the gang runs one program a rank over "
                  "the global mesh)", file=sys.stderr)
            return 2
        import signal

        from mlcomp_tpu_torch.parallel.distributed import BoundaryChannel, init_distributed
        from mlcomp_tpu_torch.utils.device import resolve_device

        init_distributed(device=resolve_device(args.device))
        dist = BoundaryChannel(port=args.sync_port)

        def stop(*_):
            # SIGTERM closes the service: the coordinator's loop then sends
            # the stop record that ends the followers' loops
            raise KeyboardInterrupt

        signal.signal(signal.SIGTERM, stop)
    slo_config = None
    if args.slo_config:
        if not args.metrics_history_interval:
            print("error: --slo-config needs the metrics-history sampler; don't combine it "
                  "with --metrics-history-interval 0", file=sys.stderr)
            return 2
        try:
            with open(args.slo_config) as f:
                slo_config = json.load(f)
            # validated before the model loads: a bad config exits 2
            from mlcomp_tpu_torch.obs.slo import validate_config

            validate_config(slo_config)
        except (OSError, ValueError) as e:
            print(f"error: --slo-config {args.slo_config!r}: {type(e).__name__}: {e}",
                  file=sys.stderr)
            return 2
    service = load_service(
        model_cfg,
        ckpt_path=ckpt,
        device=args.device,
        batch_sizes=tuple(int(x) for x in args.batch_sizes.split(",")),
        prompt_buckets=tuple(int(x) for x in args.prompt_buckets.split(",")),
        max_new_buckets=tuple(int(x) for x in args.max_new_buckets.split(",")),
        batch_window_ms=args.batch_window_ms,
        temperature=args.temperature,
        top_k=args.top_k,
        top_p=args.top_p,
        repetition_penalty=args.repetition_penalty,
        eos_id=args.eos_id,
        pad_id=args.pad_id,
        quantize=args.quantize or False,
        request_timeout_s=args.request_timeout,
        batcher=args.batcher,
        steps_per_dispatch=args.steps_per_dispatch,
        prefill_chunk=args.prefill_chunk,
        engine_pipeline_depth=args.engine_pipeline_depth,
        engine_fused_admission=False if args.engine_staged_admission else None,
        dispatch_stall_timeout=args.dispatch_stall_timeout or None,
        kv_layout=args.kv_layout,
        kv_page_tokens=args.kv_page_tokens,
        kv_pages=args.kv_pages,
        max_slots=args.max_slots,
        spec_k=args.spec_k,
        engine_spec_k=args.engine_spec_k,
        phase=args.phase,
        prefix_cache=args.prefix_cache,
        prefix_cache_bytes=args.prefix_cache_bytes,
        flight_recorder_events=args.flight_recorder_events,
        max_queue_depth=args.max_queue_depth,
        max_concurrent_requests=args.max_concurrent_requests,
        metrics_history_interval=args.metrics_history_interval,
        slo_config=slo_config,
        mesh_cfg=mesh_cfg,
        **({"dist": dist} if dist is not None else {}),
    )
    serve_http(service, args.host, args.port, model_name=str(model_cfg.get("name", "model")),
               **({"warmup": True} if args.warmup else {}))
    return 0


def _cmd_fleet(args: argparse.Namespace) -> int:
    """Serve replicas reconciled by the ReplicaManager behind the
    prefix-affinity router, optionally autoscaled from SLO burn and
    reject-rate signals; ``--phase-split P:D`` runs P prefill and D decode
    replicas, the router brokering the two-hop handoff."""
    import os
    import threading
    import time

    from mlcomp_tpu_torch.fleet import (
        Autoscaler,
        AutoscalePolicy,
        ReplicaManager,
        ReplicaSpec,
        Router,
        SchedulerLauncher,
        SubprocessLauncher,
        make_router_http_server,
    )
    from mlcomp_tpu_torch.obs.metrics import Registry

    if not args.ckpt and not args.storage_task:
        print("error: pass --ckpt or --storage-task (a checkpoint to serve)", file=sys.stderr)
        return 2
    try:
        lo, hi = (int(x) for x in args.port_range.split(":"))
    except ValueError:
        print(f"error: --port-range expects LO:HI, got {args.port_range!r}", file=sys.stderr)
        return 2
    registry_path = os.path.abspath(args.registry)
    max_replicas = args.max_replicas or max(args.replicas, args.min_replicas)
    phase_split = None
    if args.phase_split:
        if args.scheduler or args.autoscale or args.autoscale_dry_run:
            print("error: --phase-split does not combine with --scheduler or --autoscale yet"
                  " (a phase-split fleet runs two fixed replica sets)", file=sys.stderr)
            return 2
        try:
            n_prefill, n_decode = (int(x) for x in args.phase_split.split(":"))
            if n_prefill < 1 or n_decode < 1:
                raise ValueError
        except ValueError:
            print(f"error: --phase-split expects P:D with both >= 1, got {args.phase_split!r}",
                  file=sys.stderr)
            return 2
        phase_split = (n_prefill, n_decode)
    if args.scheduler:
        import yaml

        with open(args.model) as f:
            doc = yaml.safe_load(f)
        model_cfg = doc.get("model", doc) if isinstance(doc, dict) else doc
        launcher = SchedulerLauncher(
            # the store's path: the manager's thread opens its own
            # connection (sqlite's are bound to the thread that opened them)
            os.path.abspath(args.db), model_cfg, registry_path,
            # --storage-task resolves on the worker (model storage is per
            # host); only an explicit --ckpt path is forwarded as it is
            serve_args={"ckpt": args.ckpt, "storage_task": args.storage_task,
                        "host": "auto", "warmup": True},
            chips=args.chips,
        )
        port_range = None  # replicas bind ephemeral ports on their host
    else:
        serve_argv = ["--model", args.model]
        serve_argv += ["--ckpt", args.ckpt] if args.ckpt else ["--storage-task", args.storage_task]
        serve_argv += ["--warmup"]
        for extra in args.serve_arg:
            serve_argv += extra.split()
        launcher = SubprocessLauncher(serve_argv, host=args.host, log_dir=args.log_dir)
        port_range = (lo, hi)
    metrics = Registry()
    if phase_split is not None:
        n_prefill, n_decode = phase_split
        # the port window split between the sets (each manager tracks its
        # own ports); the role flags go after the user's --serve-arg extras,
        # so that argparse's last value keeps each set coherent: prefill
        # daemons run the dense admission core, decode daemons the paged
        # slot loop
        mid = lo + (hi - lo) // 2

        def strip_flags(argv, flags):
            """Drop ``--flag value`` pairs that size the decode half; a
            prefill_only engine refuses them, which would crash-loop the
            whole prefill set."""
            out, skip = [], False
            for a in argv:
                if skip:
                    skip = False
                    continue
                if a in flags:
                    skip = True
                    continue
                out.append(a)
            return out

        decode_only = ("--kv-pages", "--max-slots", "--engine-spec-k")
        managers = []
        for set_name, target, prange, base_argv, extra in (
                ("prefill", n_prefill, (lo, mid), strip_flags(serve_argv, decode_only),
                 ["--phase", "prefill", "--kv-layout", "dense"]),
                ("decode", n_decode, (mid + 1, hi), serve_argv,
                 ["--phase", "decode", "--kv-layout", "paged"])):
            managers.append(ReplicaManager(
                SubprocessLauncher(base_argv + extra, host=args.host, log_dir=args.log_dir),
                ReplicaSpec(target=target, set_name=set_name, phase=extra[1], port_range=prange,
                            health_poll_s=args.health_poll, restart_budget=args.restart_budget),
                # one unlabeled fleet gauge would have two writers: the
                # router's live_by_phase gauge reports each set instead
                metrics=None,
                registry_path=registry_path,
            ))
    else:
        managers = [ReplicaManager(
            launcher,
            ReplicaSpec(target=args.replicas, port_range=port_range,
                        health_poll_s=args.health_poll, restart_budget=args.restart_budget),
            metrics=metrics,
            registry_path=registry_path,
        )]
    manager = managers[0]
    router = Router(manager=managers if len(managers) > 1 else manager, metrics=metrics,
                    health_poll_s=min(args.health_poll, 1.0))
    scaler = None
    stop = threading.Event()
    threads = []
    if args.autoscale or args.autoscale_dry_run:
        scaler = Autoscaler(
            AutoscalePolicy(min_replicas=args.min_replicas, max_replicas=max_replicas),
            manager=manager, metrics=metrics, dry_run=args.autoscale_dry_run)

        def scale_loop():
            while not stop.wait(args.autoscale_interval):
                try:
                    d = scaler.run_tick()
                    if d["direction"] != "hold":
                        print(json.dumps({"event": "autoscale", **d}), flush=True)
                except Exception as e:
                    print(json.dumps({"event": "autoscale_error", "error": str(e)}), flush=True)

        threads.append(threading.Thread(target=scale_loop, daemon=True))
    for m in managers:
        m.start()
    router.start()
    httpd = make_router_http_server(router, args.host, args.port)
    # SIGTERM ends the fleet as Ctrl-C does, replicas stopped: they run in
    # sessions of their own, so no signal to this process reaches them
    import signal

    signal.signal(signal.SIGTERM, signal.default_int_handler)
    for t in threads:
        t.start()
    print(json.dumps({
        "event": "fleet", "router": f"http://{args.host}:{args.port}",
        "registry": registry_path,
        "replicas": sum(phase_split) if phase_split else args.replicas,
        "phase_split": f"{phase_split[0]}:{phase_split[1]}" if phase_split else None,
        "autoscale": bool(scaler), "dry_run": bool(scaler and scaler.dry_run),
    }), flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        stop.set()
        httpd.shutdown()
        httpd.server_close()
        router.close()
        for m in managers:
            m.close(stop_replicas=True)
        # a beat for subprocess replicas to die before the registry file
        # is left as state for the next incarnation
        time.sleep(0.1)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mlcomp_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("validate", help="parse and validate a DAG YAML")
    v.add_argument("config")
    v.set_defaults(fn=_cmd_validate)

    sb = sub.add_parser("submit", help="submit a DAG to the queue (the daemons run it)")
    sb.add_argument("config")
    sb.add_argument("--db", default="mlcomp.sqlite")
    sb.set_defaults(fn=_cmd_submit)

    st = sub.add_parser("status", help="list DAGs, or the tasks of one DAG")
    st.add_argument("dag", nargs="?", type=int, default=None)
    st.add_argument("--db", default="mlcomp.sqlite")
    st.set_defaults(fn=_cmd_status)

    sp = sub.add_parser("stop", help="stop a DAG (unfinished tasks -> stopped) or one --task")
    sp.add_argument("dag", nargs="?", type=int, default=None)
    sp.add_argument("--task", type=int, default=None, help="stop one task by id")
    sp.add_argument("--db", default="mlcomp.sqlite")
    sp.set_defaults(fn=_cmd_stop)

    rs = sub.add_parser("restart", help="re-run a DAG's unsuccessful tasks, or one --task")
    rs.add_argument("dag", nargs="?", type=int, default=None)
    rs.add_argument("--task", type=int, default=None,
                    help="re-run one finished task (and its skipped dependents)")
    rs.add_argument("--db", default="mlcomp.sqlite")
    rs.set_defaults(fn=_cmd_restart)

    s = sub.add_parser("supervisor", help="run the supervisor daemon")
    s.add_argument("--db", default="mlcomp.sqlite")
    s.add_argument("--poll", type=float, default=1.0)
    s.add_argument("--notify", action="append", metavar="YAML",
                   help="notifier spec, e.g. '{type: file, path: events.jsonl}' (repeatable)")
    s.set_defaults(fn=_cmd_supervisor)

    w = sub.add_parser("worker", help="run a worker daemon")
    w.add_argument("--db", default="mlcomp.sqlite")
    w.add_argument("--name", default=None)
    w.add_argument("--chips", type=int, default=0,
                   help="cards this worker advertises; an isolated task's child sees its"
                   " own through CUDA_VISIBLE_DEVICES")
    w.add_argument("--poll", type=float, default=0.5)
    w.add_argument("--workdir", default=".")
    w.add_argument("--in-process", action="store_true",
                   help="run executors inside the worker process instead of isolated"
                   " per-task children (no crash isolation, no card pinning)")
    w.add_argument("--max-tasks", type=int, default=None,
                   help="max concurrent isolated tasks (default: max(1, chips))")
    w.add_argument("--device", default="cuda",
                   help="torch device the tasks run on (default cuda; 'cpu' runs the"
                   " kernels' plain versions on the CPU)")
    w.set_defaults(fn=_cmd_worker)

    pl = sub.add_parser("pool", help="provision worker daemons over a host inventory and keep"
                        " them alive (launch, heartbeat-watch, restart, drain on stop)")
    pl.add_argument("--db", default="mlcomp.sqlite")
    pl.add_argument("--inventory", default=None,
                    help="inventory file: one host per line, optional chips=N workdir=PATH"
                    " attrs; # comments")
    pl.add_argument("--hosts", default=None,
                    help="inline inventory, comma-separated hosts (e.g. localhost,gpu-0)")
    pl.add_argument("--chips", type=int, default=0, help="default chips per host")
    pl.add_argument("--workdir", default="pool",
                    help="base dir for per-worker workdirs and logs")
    pl.add_argument("--launch", default=None,
                    help="launch template override; placeholders {host} {python} {db} {name}"
                    " {chips} {workdir} (default: direct exec for localhost, ssh -o"
                    " BatchMode=yes for remote hosts)")
    pl.add_argument("--kill", default=None,
                    help="kill template override (the same placeholders plus {signal}): how"
                    " to reach a wedged daemon on its host")
    pl.add_argument("--heartbeat-timeout", type=float, default=30.0)
    pl.add_argument("--poll", type=float, default=2.0)
    pl.set_defaults(fn=_cmd_pool)

    tk = sub.add_parser("tokenize", help="text corpus -> token .bin for the token_bin dataset"
                        " (byte-level default; --hf-tokenizer for a local vocab)")
    tk.add_argument("inputs", nargs="+", help="text files or directories")
    tk.add_argument("-o", "--output", required=True, help="output .bin path")
    tk.add_argument("--hf-tokenizer", default=None,
                    help="local pretrained tokenizer directory (needs transformers);"
                    " default is byte-level (vocab 257, EOS 256)")
    tk.set_defaults(fn=_cmd_tokenize)

    r = sub.add_parser("report", help="run the report/UI HTTP server")
    r.add_argument("--db", default="mlcomp.sqlite")
    r.add_argument("--host", default="127.0.0.1")
    r.add_argument("--port", type=int, default=8765)
    r.set_defaults(fn=_cmd_report)

    sv = sub.add_parser(
        "serve",
        help="serve an LM over HTTP on the GPU: continuous batching (or"
        " window micro-batching), KV-cache decode, bucketed shapes"
        " (POST /generate)",
    )
    sv.add_argument("--model", required=True,
                    help="YAML with the model config (a bare mapping, or a"
                    " YAML with a top-level 'model:' section)")
    sv.add_argument("--ckpt", default=None,
                    help="checkpoint directory (a train task's) or .npz params file")
    sv.add_argument("--storage-task", default=None, metavar="PROJECT/DAG/TASK",
                    help="resolve the checkpoint from model storage instead of --ckpt")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8900)
    sv.add_argument("--batch-sizes", default="1,2,4,8")
    sv.add_argument("--prompt-buckets", default="128,256,512,1024")
    sv.add_argument("--max-new-buckets", default="32,128")
    sv.add_argument("--batch-window-ms", type=float, default=10.0)
    sv.add_argument("--temperature", type=float, default=0.0)
    sv.add_argument("--top-k", type=int, default=None)
    sv.add_argument("--top-p", type=float, default=None)
    sv.add_argument("--repetition-penalty", type=float, default=1.0)
    sv.add_argument("--eos-id", type=int, default=None)
    sv.add_argument("--pad-id", type=int, default=0)
    sv.add_argument("--quantize", default=None, choices=("int8", "kernel"),
                    help="int8 weight-only: storage ('int8', dequantized at"
                    " load) or the CUDA int8 matmul ('kernel')")
    sv.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache read by the CUDA flash-decode kernel")
    sv.add_argument("--mesh", default=None, metavar="AXIS=N[,AXIS=N...]",
                    help="serve SHARDED over a mesh of processes, one rank a card: Megatron"
                    " tp weight layout (q/k/v, gate/up, lm_head column-parallel, out/down"
                    " row-parallel, KV heads over tp), decode rows over dp.  Ranks not"
                    " claimed by named axes fold into dp (e.g. 'tp=2' on 4 ranks gives dp=2"
                    " tp=2), and every --batch-sizes entry must divide dp*fsdp.  --quantize"
                    " kernel and --kv-quant compose with tp/dp meshes (each rank runs the"
                    " kernels on its shards); fsdp does not, and decode_fused is refused."
                    " The continuous engine's pipeline (depth 2) and the paged KV layout"
                    " compose with the mesh; speculative dispatch and --prefix-cache remain"
                    " single-card.  A mesh wider than one rank needs --distributed")
    sv.add_argument("--distributed", action="store_true",
                    help="serve as one rank of a gang: join the process group"
                    " (MLCOMP_TPU_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID) and run the"
                    " continuous engine over the global --mesh.  Rank 0 owns the HTTP front"
                    " door and submit queue and broadcasts per-boundary admission/retire"
                    " decisions over a TCP side channel (--sync-port) so every rank issues"
                    " the same dispatch sequence; the other ranks answer /healthz as"
                    " ready:false followers (route traffic at the coordinator) and exit when"
                    " the coordinator stops.  Every rank runs the SAME command line (same"
                    " --mesh, knobs and seed).  NCCL refuses two ranks on one card: put"
                    " them on gloo with MLCOMP_TPU_DIST_BACKEND=gloo")
    sv.add_argument("--sync-port", type=int, default=None,
                    help="--distributed boundary-channel TCP port (default:"
                    " MLCOMP_TPU_SYNC_PORT, else the coordinator port + 1)")
    sv.add_argument("--batcher", default="auto",
                    choices=("auto", "continuous", "window", "speculative"),
                    help="'continuous' (the default, 'auto'): fixed decode slots,"
                    " requests join a running decode at a dispatch boundary,"
                    " finished rows free their slot, tokens stream (POST"
                    " /generate with \"stream\": true -> SSE).  'window': one"
                    " generate per arrival window (offline batch generation)."
                    "  'speculative': B=1 latency mode, each request alone through"
                    " the n-gram speculative loop (greedy-only; see --spec-k)")
    sv.add_argument("--spec-k", type=int, default=8,
                    help="speculative batcher: draft tokens per verify forward")
    sv.add_argument("--engine-spec-k", type=int, default=None,
                    help="continuous batcher: batched speculative decoding; every"
                    " dispatch drafts and verifies K tokens per slot in one"
                    " per-row-cursor forward (greedy-only).  Replaces the K-step"
                    " dispatch, so --steps-per-dispatch is ignored (the engine"
                    " warns if both are set); with --quantize kernel keep"
                    " slots*(K+1) <= 64 or the verify leaves the int8 decode kernel")
    sv.add_argument("--steps-per-dispatch", type=_steps_per_dispatch, default=None,
                    help="continuous batcher: decode steps per dispatch (K)."
                    " Default 'adaptive': K picked per boundary from the queue"
                    " depth and slot occupancy over a 1/2/4/8 ladder (tokens"
                    " are the same under any K schedule).  An integer pins K")
    sv.add_argument("--engine-pipeline-depth", type=int, default=None,
                    help="continuous batcher: dispatches in flight (default 2);"
                    " 1 is the synchronous loop (the bisect mode)")
    sv.add_argument("--engine-staged-admission", action="store_true",
                    help="continuous batcher: run every prefill chunk at a"
                    " drained boundary instead of behind a decode dispatch"
                    " (the bisect mode; the same tokens)")
    sv.add_argument("--prefill-chunk", type=int, default=256,
                    help="continuous batcher: admission prefill chunk (tokens);"
                    " all-pad chunks are skipped")
    sv.add_argument("--dispatch-stall-timeout", type=float, default=300.0,
                    help="continuous batcher: watchdog threshold in seconds — a"
                    " dispatch stuck longer fails its requests, flips /healthz"
                    " to 503 and allows one restart of a dead loop; 0"
                    " disables the watchdog")
    sv.add_argument("--kv-layout", default="dense", choices=("dense", "paged"),
                    help="continuous batcher: device KV layout.  'paged' keeps the KV"
                    " cache as fixed-size pages read through per-slot page tables"
                    " (mlcomp_tpu_torch/kvpool): length is paid per page, admission waits"
                    " for FREE PAGES instead of reserving a worst-case row, and the slot"
                    " count grows up to --max-slots under queued traffic.  The same tokens"
                    " as 'dense' (the default)")
    sv.add_argument("--kv-page-tokens", type=int, default=None,
                    help="paged KV: tokens per page (default: the gcd of the buckets'"
                    " prefill chunk widths; must divide every chunk width)")
    sv.add_argument("--kv-pages", type=int, default=None,
                    help="paged KV: physical pages including the 2 reserved (default:"
                    " the dense layout's KV bytes)")
    sv.add_argument("--max-slots", type=int, default=None,
                    help="paged KV: elastic slot-count cap (default 4x the largest"
                    " --batch-sizes entry)")
    sv.add_argument("--prefix-cache", action="store_true",
                    help="host-RAM prefix KV cache (continuous batcher): requests sharing a"
                    " cached prompt prefix fetch its K/V rows from host memory and prefill"
                    " only the uncached suffix; responses carry cache_hit_tokens and GET"
                    " /cache/stats reports hit/miss/eviction counters")
    sv.add_argument("--prefix-cache-bytes", type=int, default=1 << 31,
                    help="host-byte budget for --prefix-cache (default 2 GiB); LRU-evicts"
                    " unpinned prefixes beyond it")
    sv.add_argument("--flight-recorder-events", type=int, default=32768,
                    help="continuous batcher: bound on the engine flight recorder's event"
                    " ring (GET /trace exports it as Chrome trace JSON); 0 disables it")
    sv.add_argument("--request-timeout", type=float, default=600.0)
    sv.add_argument("--max-queue-depth", type=int, default=0,
                    help="continuous batcher: bound on requests waiting for a slot; past it"
                    " submits fail fast with 429 + Retry-After (0 = unbounded)")
    sv.add_argument("--max-concurrent-requests", type=int, default=0,
                    help="continuous batcher: bound on in-flight requests (queued +"
                    " decoding); past it submits fail fast with 429 (0 = unbounded)")
    sv.add_argument("--metrics-history-interval", type=float, default=5.0,
                    help="seconds between metrics-history snapshots (GET /metrics/history"
                    " and the SLO burn rates); 0 disables the sampler, and /metrics/history"
                    " and /slo answer 404")
    sv.add_argument("--slo-config", default=None, metavar="FILE.json",
                    help="JSON file overriding the default SLOs (TTFT p95, per-token p50,"
                    " reject rate, engine-healthy uptime); a malformed one fails startup")
    sv.add_argument("--warmup", action="store_true",
                    help="build the CUDA kernels and launch every kernel of the served"
                    " configuration before reporting ready (/healthz ready: false until then)")
    sv.add_argument("--phase", choices=("both", "prefill", "decode"), default="both",
                    help="disaggregated serving role: 'prefill' runs the admission core"
                    " only and answers POST /prefill with KV-page handoff blobs (continuous"
                    " batcher, dense layout; --kv-page-tokens picks the page size); 'decode'"
                    " is a paged daemon that also admits handoffs through POST /import,"
                    " skipping the prefill with the same tokens; 'both' (the default) is"
                    " the monolithic daemon")
    sv.add_argument("--device", default="cuda",
                    help="torch device the model runs on (default cuda; 'cpu' runs the"
                    " kernels' plain versions on the CPU)")
    sv.set_defaults(fn=_cmd_serve)

    d = sub.add_parser("dag", help="run a DAG locally (in-process scheduler)")
    d.add_argument("config")
    d.add_argument("--workers", type=int, default=1)
    d.add_argument("--db", default=None,
                   help="persist the run's store here (default: a temp dir)")
    d.add_argument("--workdir", default=".")
    d.add_argument("--device", default="cuda",
                   help="torch device the tasks run on (default cuda; 'cpu' runs the"
                   " kernels' plain versions on the CPU)")
    d.set_defaults(fn=_cmd_dag)

    av = sub.add_parser("average", help="weight-space average of checkpoints (SWA / model"
                        " soup); saves a weights-only checkpoint that eval/infer/serve read")
    av.add_argument("sources", nargs="+", metavar="DIR[:STEP]",
                    help="checkpoint dirs (latest step unless :STEP given)")
    av.add_argument("--out", required=True, help="output checkpoint dir")
    av.add_argument("--weights", default=None,
                    help="comma-separated per-source weights (normalized)")
    av.set_defaults(fn=_cmd_average)

    fl = sub.add_parser(
        "fleet",
        help="run a managed replica fleet: serve daemons reconciled by the ReplicaManager"
        " (spawn, health-poll, bounded restart, drain on scale-down) behind the"
        " prefix-affinity router, optionally autoscaled")
    fl.add_argument("--model", required=True, help="model YAML (the file `serve` takes)")
    fl.add_argument("--ckpt", default=None,
                    help="checkpoint directory (a train task's) or .npz params file")
    fl.add_argument("--storage-task", default=None, metavar="PROJECT/DAG/TASK",
                    help="resolve the checkpoint from model storage instead of --ckpt")
    fl.add_argument("--replicas", type=int, default=2, help="initial replica target count")
    fl.add_argument("--min-replicas", type=int, default=1, help="autoscaler floor")
    fl.add_argument("--max-replicas", type=int, default=None,
                    help="autoscaler ceiling (default: --replicas)")
    fl.add_argument("--port-range", default="8901:8999", metavar="LO:HI",
                    help="ports replicas are assigned from (subprocess launcher)")
    fl.add_argument("--host", default="127.0.0.1",
                    help="router bind host (replicas bind it too)")
    fl.add_argument("--port", type=int, default=8900,
                    help="router port: clients POST /generate here")
    fl.add_argument("--registry", default="fleet-registry.json",
                    help="JSON replica registry file the manager keeps; point the report"
                    " server at it through MLCOMP_TPU_SERVE_REGISTRY for /fleet/trace and"
                    " /fleet/metrics")
    fl.add_argument("--health-poll", type=float, default=1.0,
                    help="seconds between replica /healthz polls")
    fl.add_argument("--restart-budget", type=int, default=3,
                    help="restarts per replica before the manager gives up on it (refilled"
                    " by sustained health)")
    fl.add_argument("--autoscale", action="store_true",
                    help="drive the target count from SLO burn rates and admission-control"
                    " reject ratios")
    fl.add_argument("--autoscale-dry-run", action="store_true",
                    help="compute, log and count autoscale decisions without applying them")
    fl.add_argument("--autoscale-interval", type=float, default=15.0,
                    help="seconds between autoscaler scrape-and-decide ticks")
    fl.add_argument("--scheduler", action="store_true",
                    help="launch replicas as long-lived serve_replica tasks through the --db"
                    " store (any worker runs one; the supervisor requeues a replica whose"
                    " worker dies) instead of local child processes")
    fl.add_argument("--db", default="mlcomp.sqlite", help="store for --scheduler mode")
    fl.add_argument("--chips", type=int, default=0,
                    help="chips per replica task (--scheduler mode)")
    fl.add_argument("--serve-arg", action="append", default=[],
                    help="extra flag(s) appended to each replica's `serve` command"
                    " (repeatable; subprocess launcher only), e.g. --serve-arg"
                    " '--quantize kernel'")
    fl.add_argument("--log-dir", default=None,
                    help="per-replica stdout/stderr logs (subprocess launcher)")
    fl.add_argument("--phase-split", default=None, metavar="P:D",
                    help="a disaggregated fleet instead of N monolithic replicas: P prefill"
                    " replicas (POST /prefill hands back KV-page blobs) and D decode replicas"
                    " (paged daemons admitting POST /import), the router brokering the"
                    " two-hop handoff per request.  Overrides --replicas; does not combine"
                    " with --autoscale or --scheduler")
    fl.set_defaults(fn=_cmd_fleet)

    args = p.parse_args(argv)
    from mlcomp_tpu_torch.dag.graph import DagValidationError
    from mlcomp_tpu_torch.utils.config import ConfigError

    try:
        return args.fn(args)
    except (DagValidationError, ConfigError) as e:
        # a user's config error: one clear line, no traceback
        print(f"error: {e}", file=sys.stderr)
        return 2
    except KeyboardInterrupt:
        return 130


if __name__ == "__main__":
    sys.exit(main())
