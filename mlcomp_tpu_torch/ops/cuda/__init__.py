"""Hand-written CUDA kernels (sources in ``mlcomp_tpu_torch/csrc``), each
with its plain PyTorch version and a launch counter; the counterpart of
``mlcomp_tpu/ops/pallas``."""


def launch_counts() -> dict:
    """Every wrapper's launch counter, by kernel: what a device capture's
    kernel events are held against (a record the profiler lost shows as
    fewer events than launches).  The flash backward counts one launch a
    call (its dq kernel's counter)."""
    from mlcomp_tpu_torch.ops.cuda import decode_attention as da
    from mlcomp_tpu_torch.ops.cuda import flash_attention as fa
    from mlcomp_tpu_torch.ops.cuda import page_gather as pg
    from mlcomp_tpu_torch.ops.cuda import quant_matmul as qm

    return {
        "quant_matmul": qm.launches, "quant_matmul_norm": qm.norm_launches,
        "decode_attention": da.launches, "decode_attention_chunk": da.chunk_launches,
        "paged_decode_attention": da.paged_launches,
        "paged_decode_attention_chunk": da.paged_chunk_launches,
        "flash_attention_fwd": fa.launches, "flash_attention_bwd": fa.bwd_dq_launches,
        "page_gather": pg.launches,
    }
