"""Command line of the port: ``python -m mlcomp_tpu_torch.cli serve ...``.

One command, ``serve``, with the JAX CLI's flag names.  ``--ckpt`` names
a ``.npz`` params tree (``io.weights.save_npz``).  It serves on the GPU.
"""

from __future__ import annotations

import argparse
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


def _cmd_serve(args: argparse.Namespace) -> int:
    import yaml

    from mlcomp_tpu_torch.serve import load_service, serve_http

    with open(args.model) as f:
        doc = yaml.safe_load(f)
    # a bare model mapping, or any YAML with a top-level ``model:`` section
    model_cfg = doc.get("model", doc) if isinstance(doc, dict) else doc
    if args.kv_quant:
        model_cfg = {**model_cfg, "kv_quant": True}
    if not args.ckpt:
        # serving random init silently would look healthy and emit junk
        print("error: pass --ckpt (a .npz params file to serve)", file=sys.stderr)
        return 2
    service = load_service(
        model_cfg,
        ckpt_path=args.ckpt,
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
    )
    serve_http(service, args.host, args.port, model_name=str(model_cfg.get("name", "model")))
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
    sv.add_argument("--ckpt", default=None, help=".npz params file")
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
    sv.add_argument("--batcher", default="auto", choices=("auto", "continuous", "window"),
                    help="'continuous' (the default, 'auto'): fixed decode slots,"
                    " requests join a running decode at a dispatch boundary,"
                    " finished rows free their slot, tokens stream (POST"
                    " /generate with \"stream\": true -> SSE).  'window': one"
                    " generate per arrival window (offline batch generation)")
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
    sv.add_argument("--request-timeout", type=float, default=600.0)
    sv.set_defaults(fn=_cmd_serve)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
