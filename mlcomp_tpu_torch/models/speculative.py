"""Speculative decoding with n-gram (prompt-lookup) drafting: the
counterpart of mlcomp_tpu/models/speculative.py.

A draft proposes K continuations of the sequence so far; the target model
scores all K+1 positions in ONE forward (a chunk at cache index > 0: the
int8 cache runs it through the chunk kernel, B4), and the longest prefix
that agrees with the model's own greedy choices is accepted, plus the
model's next token.  Under greedy decoding the output is the model's own
greedy stream whatever the draft proposes; a wrong draft only wastes the
verify's extra width.  "Exact" has the same caveat as in the JAX package:
the K+1-wide verify and ``generate``'s single-token step are different
launches (on the card the chunk kernel's tensor-core body against the
single-query split body, ``ops/cuda/decode_attention.chunk_plan``), so a
step whose top-2 margin sits inside their float noise may pick the other
token.  The f32 CPU fixtures are exact.

The draft is bigram prompt-lookup (:func:`ngram_propose`): the tokens that
followed the latest earlier occurrence of (last token, next token).
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def ngram_propose(ids: torch.Tensor, cur: torch.Tensor, tok0: torch.Tensor, spec_k: int,
                  pad_id: int = 0, start: Union[int, torch.Tensor] = 0) -> torch.Tensor:
    """Draft ``spec_k`` tokens per row by bigram prompt-lookup, batched
    over rows in tensor ops (no host sync).

    ``ids`` (B, T): [left pads,] prompt and accepted tokens, anything past
    ``cur``.  ``cur`` (B,): slots filled so far.  ``tok0`` (B,): the token
    about to be appended (sampled, not written yet).  ``start`` (int or
    (B,)): the first REAL slot; earlier slots never match.

    Finds the latest p with ``ids[p] == ids[cur - 1]`` and ``ids[p + 1] ==
    tok0`` strictly in the past and proposes the tokens after it; a miss,
    or a proposal reaching ``cur``, proposes ``pad_id`` (rejected by the
    verify).  Returns (B, spec_k) int64."""
    ids = ids.long()
    b, t = ids.shape
    dev = ids.device
    cur = torch.as_tensor(cur, device=dev).long().reshape(b)
    tok0 = torch.as_tensor(tok0, device=dev).long().reshape(b)
    start = torch.as_tensor(start, device=dev).long().reshape(-1, 1)
    prev = ids.gather(1, torch.clamp(cur - 1, 0, t - 1)[:, None])          # (B, 1)
    idx = torch.arange(t - 1, device=dev)[None]
    hit = ((ids[:, :-1] == prev) & (ids[:, 1:] == tok0[:, None])
           & (idx + 1 < cur[:, None]) & (idx >= start))
    # the latest hit: scores idx + 1 are distinct, 0 means none
    score = torch.where(hit, idx + 1, torch.zeros_like(idx))
    best = score.amax(dim=1)
    found = best > 0
    p = torch.where(found, best - 1, torch.zeros_like(best))
    src = torch.clamp(p[:, None] + 2 + torch.arange(spec_k, device=dev)[None], 0, t - 1)
    prop = ids.gather(1, src)
    # slots at or past cur are not the sequence yet, and a clipped window
    # would misalign: both propose pads
    keep = (src < cur[:, None]) & found[:, None]
    return torch.where(keep, prop, torch.full_like(prop, pad_id))


@torch.inference_mode()
def speculative_generate(model, prompt, max_new_tokens: int, *, prompt_mask=None,
                         spec_k: int = 4, eos_id: Optional[int] = None, pad_id: int = 0,
                         with_stats: bool = False):
    """Greedy speculative decode of ``prompt`` (1, S) or (S,) on a loaded
    ``model`` (``generation.prep_decode_variables``; int8 weights in
    kernel mode included).

    Returns (1, S + max_new_tokens) int64 ids equal to ``generate(...,
    temperature=0)`` (module docstring for the caveat), and with
    ``with_stats`` also ``{"steps": verify forwards, "emitted": tokens}``.
    ``prompt_mask`` (1, S): True on real tokens, False on LEFT padding, as
    for ``generate``; the draft never matches into the pads.  ``eos_id``:
    the row stops after emitting it (the rest stays ``pad_id``).

    B = 1 by design (the continuous engine batches rows); greedy only.
    The cache gets ``spec_k`` slots of slack past the budget, where a
    verify may write.  Each verify writes K+1 new K/V at the global index
    ``cur`` and the index is then set back to ``cur + e`` (e the tokens
    accepted): the rejected slots lie past it and the next verify
    overwrites them before any query can see them.  The cache's write
    index is a host integer, so ``e`` comes back to the host once per
    verify: that one small readback a forward stands in for the JAX
    package's on-device ``while_loop``."""
    dev = model.device
    prompt = torch.as_tensor(prompt).to(dev).long()
    if prompt.dim() == 1:
        prompt = prompt[None]
    b, s = prompt.shape
    if b != 1:
        raise ValueError(f"speculative_generate is single-sequence (B=1), got B={b}; "
                         "batch throughput is the continuous engine's job")
    if spec_k < 1:
        raise ValueError(f"spec_k must be >= 1, got {spec_k}")
    n_new = int(max_new_tokens)
    if n_new <= 0:
        return (prompt, {"steps": 0, "emitted": 0}) if with_stats else prompt
    k = int(spec_k)
    total = s + n_new
    cache = model.init_cache(1, total + k)

    if prompt_mask is not None:
        pm = torch.as_tensor(prompt_mask).to(dev).bool().reshape(1, s)
        positions = torch.clamp(torch.cumsum(pm.int(), dim=1) - 1, min=0)
        start = int(torch.argmax(pm[0].int()))
        kv_mask = torch.cat([pm, torch.ones((1, total + k - s), dtype=torch.bool,
                                            device=dev)], 1)
    else:
        positions = torch.arange(s, device=dev)[None]
        start = 0
        kv_mask = None
    last_logits = model(prompt, positions=positions, cache=cache, kv_mask=kv_mask,
                        last_only=True)[0, -1]

    ids = torch.cat([prompt[0], torch.full((n_new,), pad_id, dtype=torch.long, device=dev)])
    j = torch.arange(k + 1, device=dev)
    emitted = steps = 0
    done = False
    while not done and emitted < n_new:
        cur = s + emitted
        tok0 = torch.argmax(last_logits)
        prop = ngram_propose(ids[None], torch.tensor([cur], device=dev), tok0[None], k, pad_id,
                             start=start)[0]
        seq = torch.cat([tok0[None], prop])                        # (K+1,)
        # RoPE positions count real tokens: the slot less the pad prefix
        pos = (cur - start + j)[None]
        cache.index = cur
        lg = model(seq[None], positions=pos, cache=cache, kv_mask=kv_mask)[0]   # (K+1, V)
        greedy = torch.argmax(lg, dim=-1)
        accepted = torch.cumprod((prop == greedy[:k]).long(), 0).sum()
        e = torch.clamp(accepted + 1, max=n_new - emitted)
        any_eos = torch.zeros((), dtype=torch.bool, device=dev)
        if eos_id is not None:
            eos_hit = (seq == int(eos_id)) & (j < e)
            any_eos = eos_hit.any()
            first = torch.argmax(eos_hit.int())
            e = torch.where(any_eos, torch.minimum(e, first + 1), e)
        e_host, eos_host = torch.stack([e, any_eos.long()]).tolist()   # the one readback
        ids[cur:cur + e_host] = seq[:e_host]
        last_logits = lg[max(e_host - 1, 0)]
        cache.index = cur + e_host
        emitted += e_host
        steps += 1
        done = bool(eos_host)
    out = ids[None]
    if with_stats:
        return out, {"steps": steps, "emitted": emitted}
    return out
