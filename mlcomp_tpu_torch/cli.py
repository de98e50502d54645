"""Command line of the port: ``python -m mlcomp_tpu_torch.cli <command>``.

Three commands, with the JAX CLI's flag names:

- ``serve``: an LM over HTTP on the GPU; ``--ckpt`` names a training
  checkpoint directory or a ``.npz`` params tree (``io.weights.save_npz``),
  ``--storage-task PROJECT/DAG/TASK`` a train task's checkpoints in model
  storage.
- ``dag <yaml>``: run a DAG locally (supervisor and in-process workers,
  ``scheduler/local.run_dag_local``); its tasks run on ``--device``
  (default ``cuda``; a train task without a card fails rather than run on
  the CPU).
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
    )
    serve_http(service, args.host, args.port, model_name=str(model_cfg.get("name", "model")),
               **({"warmup": True} if args.warmup else {}))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mlcomp_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
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
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
