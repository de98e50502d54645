"""The KV-page handoff wire format: pages as a transfer currency, a copy
of mlcomp_tpu/kvpool/transfer.py (the port imports nothing of the JAX
package).  The bytes on the wire are the JAX package's, so a blob one
package encodes the other decodes.

Disaggregated serving splits a request across two replicas: a PREFILL
replica runs the admission (chunked prefill) and a DECODE replica runs
the slot loop.  What moves between them is the finished prompt's KV, in
the paged layout's unit: a page is a dense-layout TILE, so a prompt's KV
serializes as ``ceil(prompt_span / T)`` page payloads per cache leaf,
exactly the arrays a decode replica's ``PagePool`` maps into a slot
table with no re-layout, whatever the cache family (bf16/f32 K/V or the
int8 codes and bf16 scales).

One handoff blob =

    MAGIC | u64le header length | header JSON | last_logits | leaf payloads

- the header carries placement (``s_bucket``, ``start_pad``,
  ``page_tokens``), the prompt ids, the request's sampling knobs, the
  per-request sampling-stream seed, and a typed spec of every payload
  array;
- ``last_logits`` is the admission's final-token logits row: the decode
  dispatch samples token 0 from it as a local insert does;
- leaf payloads are C-order page tiles ``(n_pages, *page_rest)`` in the
  cache's canonical leaf order (``PagedLayout.kv_specs``).

bfloat16 payloads: numpy has no bf16 (the JAX package resolves the
``"bfloat16"`` token through ``ml_dtypes``, which the port does not
need).  Here a bf16 array travels as its 2-byte words under the same
``"bfloat16"`` token, so the bytes are the same: :func:`encode_handoff`
takes torch tensors (a ``torch.bfloat16`` one is written as its words)
or numpy arrays, and :func:`decode_handoff` returns CPU torch tensors,
``torch.bfloat16`` where the token says so.

Decoding VALIDATES before anything allocates: a truncated or mismatched
blob (a prefill replica dying mid-transfer) raises the typed
:class:`HandoffError`, and the decode side rejects it having touched no
pages, no leases, no slots.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, List, Tuple, Union

import numpy as np
import torch

MAGIC = b"MLCPKV1\n"
HANDOFF_VERSION = 1

__all__ = [
    "HANDOFF_VERSION",
    "HandoffError",
    "decode_handoff",
    "encode_handoff",
    "rows_to_page_tiles",
]


BF16 = "bfloat16"


def _dtype_from_token(token: str) -> np.dtype:
    """The numpy dtype a payload's bytes are read as: a bf16 payload's
    2-byte words read as int16 (viewed as ``torch.bfloat16`` after)."""
    if token == BF16:
        return np.dtype(np.int16)
    return np.dtype(token)


def _as_numpy(a: Union[np.ndarray, torch.Tensor]) -> Tuple[np.ndarray, str]:
    """An array's C-order numpy form and its dtype token; a bf16 tensor
    becomes its int16 words under the ``"bfloat16"`` token."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), BF16
        a = t.numpy()
    a = np.ascontiguousarray(a)
    # numpy's spelling with its byte order, the JAX package's for every
    # numpy dtype
    return a, a.dtype.str


class HandoffError(ValueError):
    """The handoff blob is truncated, corrupt, or shaped for a
    different engine geometry; nothing was allocated.  HTTP maps this
    to 400."""

    status = "bad_handoff"


def rows_to_page_tiles(arr: torch.Tensor, slot_axis: int, page_tokens: int) -> torch.Tensor:
    """A captured ``(1, ...)`` leaf slice whose slot axis starts ON a
    page boundary and spans ``k * page_tokens`` rows -> ``(k,
    *page_rest)`` page tiles, the exact dense-order layout the page
    tensors hold (so the import is one ``index_copy_``, no transpose)."""
    n = arr.shape[slot_axis]
    if n % page_tokens:
        raise ValueError(f"row span {n} is not a whole number of {page_tokens}-token pages")
    k = n // page_tokens
    a = arr.reshape(arr.shape[:slot_axis] + (k, page_tokens) + arr.shape[slot_axis + 1:])
    return torch.movedim(a, slot_axis, 1)[0].contiguous()


def encode_handoff(meta: Dict[str, Any], last_logits, payloads: List) -> bytes:
    """Serialize one finished prompt: ``meta`` (JSON-safe dict: the
    caller fills placement/ids/knobs), the ``(1, vocab)`` f32 logits row,
    and the per-leaf page tiles (torch tensors or numpy arrays).  Array
    specs (dtype + shape) are recorded in the header so the decoder can
    validate BEFORE it trusts a single byte count."""
    if isinstance(last_logits, torch.Tensor):
        last_logits = last_logits.detach().cpu().float().numpy()
    arrays = [_as_numpy(np.asarray(last_logits, np.float32))] + [_as_numpy(p) for p in payloads]
    header = dict(meta)
    header["version"] = HANDOFF_VERSION
    header["arrays"] = [{"dtype": tok, "shape": list(a.shape)} for a, tok in arrays]
    hj = json.dumps(header, sort_keys=True).encode()
    parts = [MAGIC, struct.pack("<Q", len(hj)), hj]
    parts += [a.tobytes() for a, _ in arrays]
    return b"".join(parts)


def decode_handoff(blob: bytes) -> Tuple[Dict[str, Any], torch.Tensor, List[torch.Tensor]]:
    """Parse + validate a handoff blob -> ``(meta, last_logits,
    payloads)``, CPU torch tensors.  Every structural problem (bad magic,
    short header, short or long body, unparsable JSON, array-spec
    mismatch) raises the typed :class:`HandoffError`; the caller has
    allocated nothing yet, so a partial transfer is rejected with zero
    cleanup."""
    if not isinstance(blob, (bytes, bytearray, memoryview)):
        raise HandoffError(f"handoff must be bytes, got {type(blob)}")
    blob = bytes(blob)
    if not blob.startswith(MAGIC):
        raise HandoffError("bad handoff magic (not a KV-page handoff)")
    off = len(MAGIC)
    if len(blob) < off + 8:
        raise HandoffError("truncated handoff: no header length")
    (hlen,) = struct.unpack_from("<Q", blob, off)
    off += 8
    if len(blob) < off + hlen:
        raise HandoffError(f"truncated handoff: header needs {hlen} bytes, "
                           f"{len(blob) - off} present")
    try:
        header = json.loads(blob[off:off + hlen])
    except ValueError as e:
        raise HandoffError(f"unparsable handoff header: {e}") from None
    off += hlen
    if not isinstance(header, dict) or header.get("version") != HANDOFF_VERSION:
        version = header.get("version") if isinstance(header, dict) else None
        raise HandoffError(f"unsupported handoff version {version!r} "
                           f"(this build speaks {HANDOFF_VERSION})")
    specs = header.get("arrays")
    if not isinstance(specs, list) or not specs:
        raise HandoffError("handoff header carries no array specs")
    arrays: List[torch.Tensor] = []
    for spec in specs:
        try:
            dt = _dtype_from_token(spec["dtype"])
            shape = tuple(int(d) for d in spec["shape"])
        except (KeyError, TypeError, ValueError) as e:
            raise HandoffError(f"bad array spec {spec!r}: {e}") from None
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        if len(blob) < off + n:
            raise HandoffError(f"truncated handoff: array {spec!r} needs {n} bytes, "
                               f"{len(blob) - off} present (partial transfer?)")
        a = torch.from_numpy(np.frombuffer(blob, dtype=dt, count=n // dt.itemsize,
                                           offset=off).reshape(shape).copy())
        arrays.append(a.view(torch.bfloat16) if spec["dtype"] == BF16 else a)
        off += n
    if off != len(blob):
        raise HandoffError(f"{len(blob) - off} trailing bytes after the last array")
    meta = {k: v for k, v in header.items() if k != "arrays"}
    return meta, arrays[0], arrays[1:]
