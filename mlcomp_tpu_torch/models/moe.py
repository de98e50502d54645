"""Mixture-of-Experts decoder LM (``moe_lm``): the counterpart of
mlcomp_tpu/models/moe.py.

Every ``moe_every``-th layer's FFN is a routed :class:`MoEBlock`; the other
layers are the transformer's ``DecoderLayer`` with ``d_ff``.  Parameter
paths are flax's (``MoELayer_{j}/moe/router/kernel`` (d, E),
``experts_w1`` (E, d, d_ff), ``experts_w2`` (E, d_ff, d), the layers
counted per class), so one tree feeds both packages
(``io.weights.init_params``, ``from_flax_params``).

- Training (``model.train()``, no cache): top-k routing over k rounds
  under a fixed capacity, dropped tokens passing through the residual,
  GShard's renormalisation of the kept gates, and the Switch load-balance
  loss, which the block leaves for the Trainer to add to the objective
  (``sown_losses``, the JAX module's sown ``losses`` collection).  Under a
  Trainer's mesh whose dp, fsdp or (with ``seq_parallel``) sp axis splits
  the tokens, the decisions are the JAX step's over the global ``(B, S)``
  tokens, which no ``shard_map`` cuts there: the capacity from the global
  count, each token's slot counted over every token before it in the
  global order (:class:`_TokenShards`), the slots filled summed over the
  ranks, and the aux loss from the global means.
- Inference (``eval()``, the default, and every decode step): drop-free
  dense routing, so a token routes the same at any token count: at 64
  tokens or fewer one einsum over every expert, above that one expert at a
  time.  Stacked int8 experts (``{"q8": (E, in, out), "q8_scale": (E, 1,
  out)}``) are decode-only and run each expert's 2-D slices through
  ``ops.quant.expert_matmul`` (B1, the int8 matmul kernel).

Served under a mesh with an ``ep`` axis (``set_serving_tp``, after
``parallel/sharding.serving_shards`` kept the rank's experts), each rank
holds ``n_experts / ep`` experts and runs the drop-free routing over them
alone: the router sees every expert, each rank adds its experts' gated
outputs, and the ep group sums the partial outputs in f32 and rounds
once.

Attention is the transformer's, with its decode-cache contract
(``cache_cursor``, ``kv_mask``, ``kv_quant``, the paged layout), so
``generate``, the window batcher and the continuous engine serve it.  The
norms feed the router and the experts too, so none folds into a kernel's
prologue (``fold_norms_eligible``).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mlcomp_tpu_torch.models import MODELS
from mlcomp_tpu_torch.models.transformer import (
    _DTYPES,
    DecoderLayer,
    Dense,
    RMSNorm,
    SelfAttention,
    TransformerLM,
)
from mlcomp_tpu_torch.ops.quant import as_tensor, expert_matmul, is_quantized_leaf
from mlcomp_tpu_torch.parallel import collectives as col
from mlcomp_tpu_torch.parallel.mesh import axis_rank, axis_size, batch_sharding, current_mesh


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot rows; an index outside [0, n) gives a zero row, as
    jax.nn.one_hot does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _expert(w, e: int):
    """Expert ``e``'s 2-D slice of a stacked weight (float or int8 leaf)."""
    if is_quantized_leaf(w):
        return {"q8": w["q8"][e], "q8_scale": w["q8_scale"][e]}
    return w[e]


class _TokenShards:
    """How a training mesh splits the global ``(B, S)`` tokens of a
    routing decision: rows over the data axes (dp x fsdp, dp major, as the
    Trainer feeds them), positions over ``sp`` when the sequence is
    sharded.  The global order is row-major, so a rank's tokens are its
    rows' shards of positions, and the tokens before a row's shard are the
    earlier rows' and that row's earlier sp shards'."""

    def __init__(self, mesh, sp: bool):
        self.data = col.data_groups(mesh)
        self.sp = mesh.get_group("sp") if sp else None
        self.groups = self.data + ([self.sp] if self.sp is not None else [])
        self.data_index, self.n_data = batch_sharding(mesh)
        self.n_sp = col.size(self.sp) if self.sp is not None else 1
        self.sp_index = col.rank(self.sp) if self.sp is not None else 0

    @staticmethod
    def of_mesh(seq_parallel) -> "Optional[_TokenShards]":
        """The installed mesh's token split, or None where no axis splits
        the tokens (the arithmetic is then the unsharded block's)."""
        mesh = current_mesh()
        if mesh is None:
            return None
        sp = bool(seq_parallel) and axis_size(mesh, "sp") > 1
        if not sp and batch_sharding(mesh)[1] == 1:
            return None
        return _TokenShards(mesh, sp)

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over every rank holding other tokens (in place)."""
        for g in self.groups:
            col.all_reduce_(t, g)
        return t

    def offsets(self, counts: torch.Tensor) -> torch.Tensor:
        """``counts`` (rows, E): this round's tokens a row of this rank
        routes to each expert.  Returns (rows, E): the tokens before each
        of this rank's row shards in the global order routed there."""
        rows = counts.shape[0]
        g = counts[None]
        if self.sp is not None:
            g = col.gather_dim(g.contiguous(), self.sp, 0)         # (n_sp, rows, E)
        for grp in self.data:
            g = col.gather_dim(g.contiguous(), grp, 1)             # (n_sp, B, E)
        per_row = g.sum(0)
        before_row = torch.cumsum(per_row, 0) - per_row
        mine = slice(self.data_index * rows, (self.data_index + 1) * rows)
        return before_row[mine] + g[:self.sp_index, mine].sum(0)


class MoEBlock(nn.Module):
    """Top-k routed expert FFN over (B, S, d) activations.  ``w1`` / ``w2``
    are the stacked expert weights, set by ``MoELM.load_state``: f32
    tensors (parameters when training) or int8 leaves.  After a training
    forward ``aux`` holds the load-balance loss and ``dropped`` the
    (token, expert) assignments the capacity refused, over the global
    tokens; otherwise both are None."""

    def __init__(self, n_experts: int, k: int = 2, capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.bfloat16, aux_weight: float = 0.01):
        super().__init__()
        self.n_experts, self.k = n_experts, k
        self.capacity_factor, self.dtype, self.aux_weight = capacity_factor, dtype, aux_weight
        # the router runs in f32: routing decisions are precision-sensitive
        self.router = Dense((n_experts,), 1, torch.float32)
        self.w1 = self.w2 = None
        self.aux: Optional[torch.Tensor] = None
        self.dropped: Optional[torch.Tensor] = None
        # training under sequence parallelism (MoELM.set_seq_parallel): the
        # block sees its rank's shard of the positions
        self.seq_parallel = False
        # serving expert-parallel (MoELM.set_serving_tp): the ep group, and
        # the first of this rank's experts
        self.ep_group = None
        self.expert0 = 0

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        b, s, d = x.shape
        t, e, dt = b * s, self.n_experts, self.dtype
        shards = _TokenShards.of_mesh(self.seq_parallel) if train else None
        t_all = t if shards is None else t * shards.n_data * shards.n_sp
        cap = max(1, int(self.capacity_factor * t_all * self.k / e))
        tokens = x.reshape(t, d)
        probs = torch.softmax(self.router(tokens.float()), dim=-1)          # (T, E)
        w1, w2 = self.w1, self.w2
        quantized = is_quantized_leaf(w1)
        if quantized and train:
            raise ValueError("int8 expert weights are decode-only")
        if not quantized:
            w1, w2 = w1.to(dt), w2.to(dt)
        self.aux = self.dropped = None
        if not train:
            return self._dense(tokens, probs, w1, w2, quantized).reshape(b, s, d)

        # top-k dispatch under a fixed capacity: round r gives each token its
        # r-th best expert, at the slot after every token routed there so far
        combine = torch.zeros((t, e, cap), dtype=torch.float32, device=x.device)
        remaining = probs
        filled = torch.zeros((e,), dtype=torch.float32, device=x.device)
        for _ in range(self.k):
            onehot = _one_hot(torch.argmax(remaining, dim=-1), e)           # (T, E)
            gate = (remaining * onehot).sum(-1)
            if shards is None:
                pos = torch.cumsum(onehot, dim=0) - onehot + filled[None]
            else:
                # within each row shard, then past every earlier token of
                # the global order (exact: counts below 2^24 in f32)
                rows = onehot.reshape(b, s, e)
                before = shards.offsets(rows.sum(1))
                pos = (torch.cumsum(rows, dim=1) - rows + before[:, None]).reshape(t, e) \
                    + filled[None]
            pos_tok = (pos * onehot).sum(-1).to(torch.int64)
            fits = (pos_tok < cap).float()
            combine = combine + (onehot[:, :, None] * _one_hot(pos_tok, cap)[:, None, :]
                                 * (fits * gate)[:, None, None])
            # only kept tokens take slots
            kept = (onehot * fits[:, None]).sum(0)
            filled = filled + (kept if shards is None else shards.sum_(kept))
            remaining = remaining * (1.0 - onehot)
        self.dropped = t_all * self.k - filled.sum()
        # GShard: renormalise over the experts that kept the token; a token
        # dropped everywhere contributes 0 (the residual carries it)
        denom = combine.sum(dim=(1, 2), keepdim=True)
        combine = torch.where(denom > 0.0, combine / denom.clamp_min(1e-9),
                              torch.zeros_like(combine))
        dispatch = (combine > 0.0).to(dt)                                   # (T, E, C)
        # Switch's load-balance loss: E * sum_e f_e * p_e
        if shards is None:
            me = probs.mean(dim=0)
            ce = dispatch.sum(dim=(0, 2)) / torch.clamp(dispatch.sum(), min=1.0)
        else:
            me = self._global_mean(probs, shards, t_all)
            per_expert = shards.sum_(dispatch.sum(dim=(0, 2)).float())
            ce = per_expert / torch.clamp(per_expert.sum(), min=1.0)
        self.aux = self.aux_weight * e * torch.sum(me * ce)
        expert_in = torch.einsum("tec,td->ecd", dispatch, tokens.to(dt))
        h = _gelu(torch.einsum("ecd,edf->ecf", expert_in, w1))
        expert_out = torch.einsum("ecf,efd->ecd", h, w2)
        out = torch.einsum("tec,ecd->td", combine.to(dt), expert_out)
        return out.reshape(b, s, d)

    @staticmethod
    def _global_mean(probs: torch.Tensor, shards: _TokenShards, t_all: int) -> torch.Tensor:
        """The router probabilities' mean over the global tokens.  Its
        gradient reaches this rank's tokens n_data times over: the Trainer
        averages the data ranks' gradients (where the JAX step's global
        aux differentiates once through every token) and sums the sp
        ranks'."""
        local = probs.sum(0)
        total = shards.sum_(local.detach().clone())
        scaled = local * shards.n_data
        return (total + scaled - scaled.detach()) / t_all

    def _dense(self, tokens, probs, w1, w2, quantized: bool) -> torch.Tensor:
        """Drop-free routing: every token to its top-k experts, gates
        renormalised over them.  Expert-parallel, over this rank's experts,
        the partial outputs summed over the ep group."""
        t, e, dt = tokens.shape[0], self.n_experts, self.dtype
        topv, topi = torch.topk(probs, self.k, dim=-1)
        gates = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
        weight = (_one_hot(topi, e) * gates[..., None]).sum(1)              # (T, E)
        if self.ep_group is not None:
            n_local = (w1["q8"] if quantized else w1).shape[0]
            weight = weight[:, self.expert0:self.expert0 + n_local]
            return col.reduce_from(self._experts(tokens, weight, w1, w2, quantized),
                                   self.ep_group)
        return self._experts(tokens, weight, w1, w2, quantized)

    def _experts(self, tokens, weight, w1, w2, quantized: bool) -> torch.Tensor:
        """The gated sum of the held experts' outputs (``weight`` (T, E) the
        gates of those experts)."""
        t, e, dt = tokens.shape[0], weight.shape[1], self.dtype
        toks = tokens.to(dt)
        if not quantized and t <= 64:
            # decode-step token counts: the whole expert axis in one einsum
            h_all = _gelu(torch.einsum("td,edf->etf", toks, w1))
            return torch.einsum("etf,efd,te->td", h_all, w2, weight.to(dt))
        # one expert at a time: the intermediate is (T, d_ff), not E times it
        if quantized:
            def mm(a, w):
                return expert_matmul(a, w, dt)
        else:
            def mm(a, w):
                return a @ w
        out = torch.zeros((t, tokens.shape[1]), dtype=dt, device=tokens.device)
        for i in range(e):
            h_i = _gelu(mm(toks, _expert(w1, i)))
            out = out + weight[:, i, None].to(dt) * mm(h_i, _expert(w2, i))
        return out


class MoELayer(nn.Module):
    """A decoder layer whose FFN is a routed :class:`MoEBlock`; the
    ``DecoderLayer`` call signature, so the LM's loop and its caches take
    either."""

    def __init__(self, hidden, heads, kv_heads, n_experts, k, capacity_factor, dtype, kv_quant,
                 device):
        super().__init__()
        self.attn = SelfAttention(hidden, heads, kv_heads, dtype, kv_quant, False, device)
        self.norm = RMSNorm(hidden, dtype, device)
        self.moe = MoEBlock(n_experts, k, capacity_factor, dtype)

    def ffn_linears(self, pre: str):
        return [(self.moe, "router", (pre, "moe", "router", "kernel"))]

    def forward(self, x, positions, cache=None, index=0, kv_mask=None, kv_start=None,
                fold=False, cursor=None):
        x = self.attn(x, positions, cache, index, kv_mask, kv_start, fold, cursor)
        return x + self.moe(self.norm(x), train=self.training and cache is None)


@MODELS.register("moe_lm")
class MoELM(TransformerLM):
    """``moe_lm`` with the JAX package's config keys; ``forward`` returns f32
    logits (the f32 ``lm_head``).  Built in eval mode, the JAX module's
    ``train=False``: the Trainer's step switches it to ``train()``."""

    fold_norms_eligible = False

    def __init__(self, vocab_size: int = 32000, hidden: int = 512, layers: int = 8,
                 heads: int = 8, kv_heads: Optional[int] = None, n_experts: int = 8,
                 d_ff: Optional[int] = None, k: int = 2, capacity_factor: float = 1.25,
                 moe_every: int = 2, dtype: str = "bfloat16",
                 seq_parallel: "bool | str" = False, kv_quant: bool = False,
                 decode_fused: bool = False, device=None):
        if decode_fused:
            raise ValueError("moe_lm has no fused decode layout (decode_fused)")
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
        d_ff = d_ff or hidden * 4
        super().__init__(vocab_size, hidden, 0, heads, kv_heads, d_ff, dtype, kv_quant,
                         seq_parallel=seq_parallel, device=device)
        self.n_experts, self.k, self.moe_every = n_experts, k, moe_every
        self.capacity_factor = capacity_factor
        dt, kvh = _DTYPES[dtype], self.kv_heads
        self._names: List[str] = []
        mods = []
        counts = {"DecoderLayer": 0, "MoELayer": 0}
        for i in range(layers):
            if (i + 1) % moe_every == 0:
                mods.append(MoELayer(hidden, heads, kvh, n_experts, k, capacity_factor, dt,
                                     kv_quant, self.device))
                cls = "MoELayer"
            else:
                mods.append(DecoderLayer(hidden, heads, kvh, d_ff, dt, kv_quant, False,
                                         self.device))
                cls = "DecoderLayer"
            self._names.append(f"{cls}_{counts[cls]}")
            counts[cls] += 1
        self.layers = nn.ModuleList(mods)
        self.set_seq_parallel()
        self.train(False)

    def arch(self) -> dict:
        return {"name": "moe_lm", "vocab_size": self.vocab_size, "hidden": self.hidden,
                "layers": len(self.layers), "heads": self.heads, "kv_heads": self.kv_heads,
                "n_experts": self.n_experts, "d_ff": self.mlp_dim, "moe_every": self.moe_every}

    def layer_names(self) -> List[str]:
        return list(self._names)

    def moe_blocks(self):
        """``(flax path prefix, MoEBlock)`` of every MoE layer."""
        return [(f"{pre}/moe", layer.moe) for pre, layer in zip(self._names, self.layers)
                if isinstance(layer, MoELayer)]

    def load_state(self, state: dict, train: bool = False) -> None:
        """As ``TransformerLM.load_state``, plus each MoE layer's stacked
        experts (``<layer>/moe/experts_w1`` / ``_w2``): f32 parameters in
        their flax shapes when ``train``, else the tensors or int8 leaves as
        they come (int8 is decode-only)."""
        super().load_state(state, train)
        dev = self.device
        for pre, blk in self.moe_blocks():
            for name in ("w1", "w2"):
                leaf = state[f"{pre}/experts_{name}"]
                if is_quantized_leaf(leaf):
                    if train:
                        raise ValueError(f"{pre}: int8 expert weights are decode-only")
                    leaf = {k: as_tensor(v).to(dev).contiguous() for k, v in leaf.items()}
                elif train:
                    leaf = nn.Parameter(as_tensor(leaf).to(dev, torch.float32, copy=True))
                else:
                    leaf = as_tensor(leaf).to(dev)
                setattr(blk, name, leaf)

    def flax_params(self) -> "dict[str, torch.Tensor]":
        out = super().flax_params()
        for pre, blk in self.moe_blocks():
            out[f"{pre}/experts_w1"] = blk.w1
            out[f"{pre}/experts_w2"] = blk.w2
        return out

    def ep_local_paths(self, ep: int) -> set:
        """The stacked expert weights served expert-parallel on a mesh with
        ``ep`` ranks (where the expert count divides)."""
        if ep <= 1 or self.n_experts % ep:
            return set()
        return {f"{pre}/experts_{n}" for pre, _ in self.moe_blocks() for n in ("w1", "w2")}

    def set_seq_parallel(self) -> None:
        """As ``TransformerLM.set_seq_parallel``, and the MoE blocks learn
        that a training forward sees a shard of the positions."""
        super().set_seq_parallel()
        for layer in self.layers:
            if isinstance(layer, MoELayer):
                layer.moe.seq_parallel = self.seq_parallel

    def set_serving_tp(self, mesh) -> None:
        """As ``TransformerLM.set_serving_tp``, plus the ep group and first
        expert of every MoE block holding this rank's experts."""
        super().set_serving_tp(mesh)
        ep = axis_size(mesh, "ep")
        if not self.ep_local_paths(ep):
            return
        for _, blk in self.moe_blocks():
            blk.ep_group = mesh.get_group("ep")
            blk.expert0 = axis_rank(mesh, "ep") * (self.n_experts // ep)

    def sown_losses(self) -> List[torch.Tensor]:
        """The load-balance losses of the last training forward, one a MoE
        layer (none after an inference forward)."""
        return [blk.aux for _, blk in self.moe_blocks() if blk.aux is not None]
