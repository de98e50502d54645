"""Pipeline-parallel decoder LM: depth sharded over the ``pp`` mesh axis.

The counterpart of mlcomp_tpu/models/pipeline_lm.py, registered as the
JAX package registers it, ``transformer_lm_pp``.  Each pp rank holds
``layers/pp`` decoder layers and activations rotate through the ring
(``parallel/pipeline.py``: GPipe when ``layers == pp``, the interleaved
circular schedule when ``layers = v*pp``).

- Decoder-layer weights live in STACKED parameters (leading axis =
  layers, flax paths ``stages_q``, ``stages_ln1``, ...), which
  ``spec_for`` places ``P("pp")``: each rank holds exactly its slices.
- The embedding, the final norm and ``lm_head`` run on every rank; the
  head scores the last rank's pipeline output, which the pp group then
  shares (``broadcast_from``: the cotangent stays with the last rank, so
  every replicated weight's gradient is a sum over pp).
- On a mesh without a pp axis the same stacks run one layer after
  another: the schedule-free reference path the tests compare against.
- ``device_ordered_pp = N`` stores the stacks in device order for pp=N;
  the sequential path un-permutes them, and a mismatched pp is refused.

The per-layer math mirrors models/transformer.py's DecoderLayer (RMSNorm
pre-norm, RoPE, GQA attention through ``dot_product_attention``, SwiGLU).
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mlcomp_tpu_torch.models import MODELS
from mlcomp_tpu_torch.models.transformer import _DTYPES, Dense, Embed, apply_rope, rmsnorm
from mlcomp_tpu_torch.ops.attention import dot_product_attention
from mlcomp_tpu_torch.parallel import collectives as col
from mlcomp_tpu_torch.parallel.mesh import axis_size, current_mesh
from mlcomp_tpu_torch.parallel.pipeline import deinterleave_stage_params, pipeline_local

STAGE_LEAVES = ("ln1", "q", "k", "v", "out", "ln2", "gate", "up", "down")


def _decoder_stage(params: Dict[str, torch.Tensor], h: torch.Tensor, *, heads: int,
                   kv_heads: int, dtype: torch.dtype) -> torch.Tensor:
    """One decoder layer on (mbs, S, hidden) activations; params is one
    stage's slice of the stacked weights."""
    mbs, s, hidden = h.shape
    d_head = hidden // heads
    positions = torch.arange(s, device=h.device)[None].expand(mbs, s)

    x = rmsnorm(h, params["ln1"], dtype)
    q = (x @ params["q"].to(dtype)).reshape(mbs, s, heads, d_head)
    k = (x @ params["k"].to(dtype)).reshape(mbs, s, kv_heads, d_head)
    v = (x @ params["v"].to(dtype)).reshape(mbs, s, kv_heads, d_head)
    q = apply_rope(q, positions)
    k = apply_rope(k, positions)
    attn = dot_product_attention(q, k, v, causal=True)
    h = h + attn.reshape(mbs, s, heads * d_head) @ params["out"].to(dtype)

    x = rmsnorm(h, params["ln2"], dtype)
    g = F.silu(x @ params["gate"].to(dtype)) * (x @ params["up"].to(dtype))
    return h + g @ params["down"].to(dtype)


@MODELS.register("transformer_lm_pp")
class PipelinedTransformerLM(nn.Module):
    """``transformer_lm_pp`` with the JAX package's config keys; ``forward``
    returns f32 logits.  Weights load through ``load_state`` (flax paths,
    ``io.weights.from_flax_params(..., fold=False)``)."""

    def __init__(self, vocab_size: int = 32000, hidden: int = 512, layers: int = 8,
                 heads: int = 8, kv_heads: Optional[int] = None, mlp_dim: Optional[int] = None,
                 dtype: str = "bfloat16", n_microbatches: int = 0, remat: bool = True,
                 device_ordered_pp: int = 0, device=None):
        super().__init__()
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
        self.vocab_size, self.hidden, self.n_layers, self.heads = vocab_size, hidden, layers, heads
        self.kv_heads = kv_heads or heads
        self.mlp_dim = mlp_dim or hidden * 4
        self.dtype = _DTYPES[dtype]
        self.n_microbatches, self.remat = int(n_microbatches), bool(remat)
        self.device_ordered_pp = int(device_ordered_pp)
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.emb = Embed(self.dtype)
        self.lm_head = Dense((vocab_size,), 1, torch.float32)
        for name in STAGE_LEAVES:
            self.register_buffer(f"stages_{name}", None)
        self.register_buffer("final_norm", None)

    def arch(self) -> dict:
        return {"name": "transformer_lm_pp", "vocab_size": self.vocab_size,
                "hidden": self.hidden, "layers": self.n_layers, "heads": self.heads,
                "kv_heads": self.kv_heads, "mlp_dim": self.mlp_dim}

    def load_state(self, state: dict, train: bool = False) -> None:
        """Load the flat flax-path state (``emb/embedding``, ``stages_*``,
        ``final_norm``, ``lm_head/kernel``); with ``train`` each becomes an
        f32 ``nn.Parameter``."""
        dev = self.device

        def value(t):
            return (nn.Parameter(t.to(dev, torch.float32, copy=True)) if train
                    else t.to(dev, torch.float32))

        for name in STAGE_LEAVES:
            setattr(self, f"stages_{name}", value(state[f"stages_{name}"]))
        self.final_norm = value(state["final_norm"])
        self.emb.weight = value(state["emb/embedding"])
        self.lm_head.kernel = value(state["lm_head/kernel"])

    def flax_params(self) -> "dict[str, torch.Tensor]":
        out = {"emb/embedding": self.emb.weight, "final_norm": self.final_norm,
               "lm_head/kernel": self.lm_head.kernel}
        for name in STAGE_LEAVES:
            out[f"stages_{name}"] = getattr(self, f"stages_{name}")
        return out

    def split_axes(self) -> set:
        """``pp`` when the mesh pipelines the stages: each rank's share of
        the replicated weights' gradients is summed over the pp group."""
        return {"pp"} if axis_size(current_mesh(), "pp") > 1 else set()

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        stage_fn = partial(_decoder_stage, heads=self.heads, kv_heads=self.kv_heads,
                           dtype=self.dtype)
        stages = {name: getattr(self, f"stages_{name}") for name in STAGE_LEAVES}
        h = self.emb(ids.long())

        mesh = current_mesh()
        pp = axis_size(mesh, "pp")
        if pp > 1 and self.n_layers % pp:
            raise ValueError(f"{self.n_layers} layers not a multiple of pp={pp}")
        if self.device_ordered_pp:
            if self.n_layers % self.device_ordered_pp:
                raise ValueError(
                    f"{self.n_layers} layers not a multiple of "
                    f"device_ordered_pp={self.device_ordered_pp}")
            if pp > 1 and pp != self.device_ordered_pp:
                # a device-ordered stack on the wrong pp would silently run
                # the layers in the wrong order: refuse
                raise ValueError(
                    f"params are device-ordered for pp={self.device_ordered_pp} "
                    f"but the mesh has pp={pp}; convert with "
                    "parallel.pipeline.deinterleave_stage_params")
        if pp > 1:
            n_micro = self.n_microbatches or pp
            b = h.shape[0]
            if b % n_micro:
                raise ValueError(
                    f"this rank's batch {b} must split into n_microbatches={n_micro} "
                    "microbatches; adjust batch_size or the model's n_microbatches")
            group = col.group_of(mesh, "pp")
            # stages: this rank's P("pp") slices (parallel/sharding.py)
            h = pipeline_local(stage_fn, stages, h, n_micro, group, remat=self.remat,
                               network_order=not self.device_ordered_pp)
            logits = self._head(h)
            return col.broadcast_from(logits, group, pp - 1)
        # no pp axis: the same stacked params one layer after another, the
        # schedule-free reference path
        if self.device_ordered_pp:
            stages = deinterleave_stage_params(stages, self.device_ordered_pp)
        body = ((lambda p, x: checkpoint(stage_fn, p, x, use_reentrant=False))
                if self.remat and torch.is_grad_enabled() else stage_fn)
        for i in range(self.n_layers):
            h = body({name: x[i] for name, x in stages.items()}, h)
        return self._head(h)

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        h = rmsnorm(h, self.final_norm, self.dtype)
        return self.lm_head(h).float()
