"""Page gather (csrc/page_gather.cu, B8): ``(P, *rest)`` pages through an
``(S, MP)`` int32 table into ``(S, MP, *rest)``, for any dtype.

The counterpart of ``_gather_leaf_pallas`` in
mlcomp_tpu/kvpool/layout.py: a byte copy of one page per (s, p).  A
CUDA tensor launches the kernel; a CPU tensor takes :func:`page_gather_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from mlcomp_tpu_torch.ops.cuda import build

launches = 0


def page_gather_plain(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``pages[table]``: the plain version."""
    return pages[table.long()]


def page_gather(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Gather physical pages ``table[s, p]`` of ``pages`` (P, *rest) into
    (S, MP, *rest).  Every entry of ``table`` must index a page of
    ``pages`` (the kernel does not check it: that would need a sync)."""
    global launches
    if table.dim() != 2:
        raise ValueError(f"table must be (S, MP); got {tuple(table.shape)}")
    if pages.device.type == "cpu":
        return page_gather_plain(pages, table)
    if pages.device.type != "cuda":
        raise ValueError(f"page_gather runs on cuda or cpu tensors, not {pages.device}")
    if table.device != pages.device or table.dtype != torch.int32:
        raise TypeError("table must be int32 on the pages' device")
    if not pages.is_contiguous():
        raise ValueError("pages must be contiguous")
    table = table.contiguous()
    s, mp = table.shape
    out = torch.empty((s, mp) + tuple(pages.shape[1:]), dtype=pages.dtype, device=pages.device)
    row_bytes = pages[0].numel() * pages.element_size() if pages.shape[0] else 0
    p = ctypes.c_void_p
    launch = build.function("page_gather", "page_gather_launch",
                            [p, p, p, ctypes.c_int, ctypes.c_longlong, p])
    err = launch(pages.data_ptr(), table.data_ptr(), out.data_ptr(), s * mp, row_bytes,
                 build.stream_ptr(pages.device))
    build.check(err, "page_gather")
    launches += 1
    return out
