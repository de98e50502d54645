"""Autoregressive generation: KV-cache decode loop and sampling.

The counterpart of mlcomp_tpu/models/generation.py.  One batched prefill
at cache index 0 absorbs the prompt; then each step samples a token and
runs a single-token forward against the cache, which the model updates in
place.  The loop is a Python loop of device work: nothing in it reads a
value back to the host, so the host only waits at the end, when the ids
come back.  Ragged prompts batch by LEFT-padding (``prompt_mask``), which
sets per-row RoPE positions and masks the pad slots.

Randomness is an explicit ``torch.Generator`` on the model's device, or,
for the continuous engine, a counter-based hash of (engine seed, request
seed, token position) (:func:`sample_token_rowwise_keyed`).  Both draw
other numbers than ``jax.random`` for the same seed, so sampled (not
greedy) tokens are comparable between the packages only as distributions.
"""

from __future__ import annotations

from typing import Optional

import torch

from mlcomp_tpu_torch.ops.quant import (
    dequantize_nonkernel_params,
    dequantize_params,
    fold_kernel_leaves,
    has_quantized,
)


def init_cache(model, batch_size: int, max_len: int):
    """A zeroed decode cache for ``(batch_size, max_len)``."""
    return model.init_cache(batch_size, max_len)


def process_logits(logits: torch.Tensor, temperature: float, top_k: Optional[int],
                   top_p: Optional[float]) -> torch.Tensor:
    """Temperature/top-k/top-p filtering over (B, V) logits (static knobs)."""
    logits = logits.float() / max(temperature, 1e-6)
    if top_k is not None:
        if top_k <= 0:
            raise ValueError(f"top_k must be positive, got {top_k}")
        kth = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None:
        if top_p <= 0.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if top_p < 1.0:
            sorted_logits = torch.sort(logits, dim=-1, descending=True).values
            probs = torch.softmax(sorted_logits, dim=-1)
            keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
            cutoff = torch.where(keep, sorted_logits, torch.full_like(sorted_logits, float("inf"))
                                 ).amin(-1, keepdim=True)
            logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def _categorical(generator: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row from softmax(logits) (the exponential race:
    argmax(logits - log E) with E ~ Exp(1)); -inf logits never win."""
    e = torch.empty_like(logits, dtype=torch.float32).exponential_(generator=generator)
    return torch.argmax(logits - torch.log(e), dim=-1)


def sample_token(generator, logits, temperature: float = 1.0, top_k=None, top_p=None):
    """Next tokens (B,) from (B, V) logits; temperature 0 is greedy."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    return _categorical(generator, process_logits(logits, temperature, top_k, top_p))


def process_logits_rowwise(logits: torch.Tensor, temperature: torch.Tensor,
                           top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Per-row filters: (B,) temperature, top_k, top_p.  ``top_k >= V`` and
    ``top_p >= 1`` keep everything; one descending sort serves both."""
    v = logits.shape[-1]
    logits = logits.float() / torch.clamp(temperature, min=1e-6)[:, None]
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    kth = sorted_logits.gather(-1, (torch.clamp(top_k, 1, v) - 1).long()[:, None])
    neg = torch.full_like(sorted_logits, float("-inf"))
    sl_k = torch.where(sorted_logits < kth, neg, sorted_logits)
    probs = torch.softmax(sl_k, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_p[:, None]
    cutoff = torch.where(keep, sl_k, torch.full_like(sl_k, float("inf"))).amin(-1, keepdim=True)
    logits = logits.masked_fill(logits < kth, float("-inf"))
    return logits.masked_fill(logits < cutoff, float("-inf"))


def sample_token_rowwise(generator, logits, temperature, top_k, top_p,
                         any_sampled: bool = True) -> torch.Tensor:
    """Rows with ``temperature <= 0`` decode greedily, the rest sample
    through the row-wise filters.  ``any_sampled=False`` (decided once on
    the host, outside the token loop) skips the sampling work."""
    greedy = torch.argmax(logits, dim=-1)
    if not any_sampled:
        return greedy
    sampled = _categorical(generator, process_logits_rowwise(logits, temperature, top_k, top_p))
    return torch.where(temperature <= 0.0, greedy, sampled)


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32) without overflowing
    int64: the constant splits into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit avalanche hash (Wellons' lowbias32) over int64 tensors
    holding values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keyed_uniform(seed: int, rseed: torch.Tensor, position: torch.Tensor,
                  n: int) -> torch.Tensor:
    """(B, n) uniforms in (0, 1), a pure function of (engine ``seed``, each
    row's request seed ``rseed`` (B,), the row's token ``position`` (B,),
    column index): a counter-based generator in plain integer ops, so a
    row's draw for one token never depends on which batch, dispatch or
    neighbours it was drawn with."""
    golden = 0x9E3779B9
    key = _hash32(torch.full_like(rseed, seed & _M32, dtype=torch.int64))
    key = _hash32((key + _mul32(rseed.long() & _M32, golden)) & _M32)
    key = _hash32((key ^ (position.long() & _M32)) & _M32)
    cols = torch.arange(n, device=rseed.device, dtype=torch.int64)
    h = _hash32((key[:, None] + _mul32(cols[None] + 1, golden)) & _M32)
    return _unit(_hash32(h ^ key[:, None]))


def _unit(h: torch.Tensor) -> torch.Tensor:
    """float32 uniforms in (0, 1) from 32-bit hashes: the 23 high bits,
    centred in their interval.  float32 holds ``(k + 0.5) * 2^-23`` exactly
    for every 23-bit k, so the largest draw is ``1 - 2^-24``; with 24 bits
    the top one would round to 1.0, and ``-log(-log(1))`` wins any race."""
    return ((h >> 9).float() + 0.5) * (1.0 / (1 << 23))


def sample_token_rowwise_keyed(seed: int, rseed: torch.Tensor, position: torch.Tensor,
                               logits: torch.Tensor, temperature: torch.Tensor,
                               top_k: torch.Tensor, top_p: torch.Tensor,
                               any_sampled: bool = True) -> torch.Tensor:
    """:func:`sample_token_rowwise` with a PER-ROW key: row r's draw for the
    token at ``position[r]`` comes from (``seed``, ``rseed[r]``,
    ``position[r]``) alone, through the exponential race
    ``argmax(logits - log E)`` with ``E = -log U`` and ``U`` from
    :func:`keyed_uniform`.  The continuous engine keys every request this
    way, so its sampled tokens are the same under any dispatch depth,
    pipeline depth or join order (the JAX package's
    ``fold_in(fold_in(rng, request), position)``; the bits differ)."""
    greedy = torch.argmax(logits, dim=-1)
    if not any_sampled:
        return greedy
    proc = process_logits_rowwise(logits, temperature, top_k, top_p)
    e = -torch.log(keyed_uniform(seed, rseed, position, logits.shape[-1]))
    sampled = torch.argmax(proc - torch.log(e), dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled)


def prep_decode_variables(model, params, quant_kernel: bool = False):
    """Load a flax-layout params tree into ``model`` with the decode prep of
    the JAX package: an int8 tree is dequantized once to bf16
    (``quant_kernel`` False), or keeps its kernel-consumable leaves int8 for
    the CUDA kernel with every other leaf dequantized and the RMSNorms
    folded into the projections' prologues (``quant_kernel`` True); a float
    tree loads as it is.  Returns the model."""
    from mlcomp_tpu_torch.io.weights import from_flax_params

    use_quant_kernel = False
    if has_quantized(params):
        use_quant_kernel = bool(quant_kernel)
        deq = dequantize_nonkernel_params if quant_kernel else dequantize_params
        params = deq(params, torch.bfloat16)
        if use_quant_kernel:
            params = fold_kernel_leaves(params)
    model.load_state(from_flax_params(params))
    model.fold_norms = use_quant_kernel
    return model


def _rows(x, b: int, dtype, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype).reshape(-1).to(device).expand(b)


@torch.inference_mode()
def generate(model, prompt, max_new_tokens: int, *, prompt_mask=None,
             temperature=0.0, top_k=None, top_p=None, eos_id=None, pad_id: int = 0,
             generator: Optional[torch.Generator] = None, with_logprobs: bool = False,
             repetition_penalty=None):
    """Generate ``max_new_tokens`` continuations of ``prompt`` (B, S).

    ``prompt_mask`` (B, S): True on real tokens, False on LEFT-padding.
    ``eos_id``: rows emit ``pad_id`` after producing it (an int, or a (B,)
    array where -1 means none).  Sampling knobs that are Python numbers
    apply to every row; ``temperature`` as a (B,) array switches to per-row
    sampling (``top_k``/``top_p``/``repetition_penalty`` rows optional).
    ``repetition_penalty`` (rowwise only): seen tokens (real prompt ids
    and everything generated) get the HF adjustment before sampling;
    reported logprobs stay raw-model.

    Returns (B, S + max_new_tokens) int64 ids on the model's device, and
    with ``with_logprobs`` also (B, max_new_tokens) f32 log-probabilities
    of the emitted tokens under the unfiltered logits (0 past EOS)."""
    dev = model.device
    prompt = torch.as_tensor(prompt).to(dev).long()
    b, s = prompt.shape
    if max_new_tokens <= 0:
        if with_logprobs:
            return prompt, torch.zeros((b, 0), dtype=torch.float32, device=dev)
        return prompt
    cache = model.init_cache(b, s + max_new_tokens)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    if prompt_mask is not None:
        pm = torch.as_tensor(prompt_mask).to(dev).bool()
        positions = torch.clamp(torch.cumsum(pm.int(), dim=1) - 1, min=0)
        real_len = pm.sum(1)
        kv_mask = torch.cat([pm, torch.ones((b, max_new_tokens), dtype=torch.bool, device=dev)], 1)
    else:
        pm = None
        positions = torch.arange(s, device=dev)[None].expand(b, s)
        real_len = torch.full((b,), s, dtype=torch.long, device=dev)
        kv_mask = None

    last_logits = model(prompt, positions=positions, cache=cache, kv_mask=kv_mask,
                        last_only=True)[:, -1]

    rowwise = not isinstance(temperature, (int, float))
    if rowwise:
        # the knobs come from the host: decide once, before the loop,
        # whether any row samples
        t_host = torch.as_tensor(temperature, dtype=torch.float32).reshape(-1)
        any_sampled = bool((t_host > 0).any())
        t_row = _rows(t_host, b, torch.float32, dev)
        k_row = _rows(model.vocab_size if top_k is None else top_k, b, torch.int64, dev)
        p_row = _rows(1.0 if top_p is None else top_p, b, torch.float32, dev)
        rp_row = (None if repetition_penalty is None
                  else _rows(repetition_penalty, b, torch.float32, dev))
    elif repetition_penalty is not None:
        raise ValueError(
            "repetition_penalty needs the rowwise sampling path: pass "
            "temperature as a (B,) array"
        )
    use_rp = rowwise and repetition_penalty is not None
    eos = None
    if eos_id is not None:
        eos = _rows(eos_id, b, torch.int64, dev)

    presence = None
    if use_rp:
        seeds = pm if pm is not None else torch.ones((b, s), dtype=torch.bool, device=dev)
        seen = torch.zeros((b, last_logits.shape[-1]), dtype=torch.int32, device=dev)
        presence = seen.scatter_add_(1, prompt, seeds.int()) > 0
    rows = torch.arange(b, device=dev)

    def next_token(logits, done):
        if rowwise:
            adj = logits
            if use_rp:
                rp = rp_row[:, None]
                la = adj.float()
                adj = torch.where(presence, torch.where(la > 0, la / rp, la * rp), la)
            tok = sample_token_rowwise(generator, adj, t_row, k_row, p_row, any_sampled)
        else:
            tok = sample_token(generator, logits, temperature, top_k, top_p)
        tok = torch.where(done, torch.full_like(tok, pad_id), tok)
        if with_logprobs:
            lp = torch.log_softmax(logits.float(), dim=-1).gather(-1, tok[:, None])[:, 0]
            lp = torch.where(done, torch.zeros_like(lp), lp)
        else:
            lp = None
        new_done = done | (tok == eos) if eos is not None else done
        return tok, lp, new_done

    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    pos = real_len.long()
    toks, lps = [], []
    for _ in range(max_new_tokens - 1):
        tok, lp, new_done = next_token(last_logits, done)
        if use_rp:
            presence[rows, tok] |= ~done
        toks.append(tok)
        lps.append(lp)
        last_logits = model(tok[:, None], positions=pos[:, None], cache=cache,
                            kv_mask=kv_mask, last_only=True)[:, -1]
        done, pos = new_done, pos + 1
    tok, lp, _ = next_token(last_logits, done)
    toks.append(tok)
    lps.append(lp)
    ids = torch.cat([prompt, torch.stack(toks, 1)], 1)
    if with_logprobs:
        return ids, torch.stack(lps, 1)
    return ids
