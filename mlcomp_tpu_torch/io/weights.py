"""Weights carried across from the JAX package, and the ``.npz`` format of
the CLI's ``--ckpt``.

Trees keep the flax layout: nested dicts keyed by flax module names
(``DecoderLayer_3/attn/q/kernel`` is (d, H, dh), ``attn/out/kernel``
(H, dh, d)), leaves numpy arrays or tensors, quantized leaves
``{"q8", "q8_scale"}``.  :func:`from_flax_params` flattens such a tree
into the state ``TransformerLM.load_state`` takes, folding every
projection to its 2-D (m, n) operand.  The zoo's models (models/zoo.py)
keep their trees as they are, flattened by path (:func:`flatten`): a
Conv kernel stays HWIO and a ``DenseGeneral`` kernel (d, H, dh) or
(H, dh, d), and the layer reads it in that shape.  :func:`init_params`
draws either family's tree, :func:`init_variables` a zoo model's
``(params, model_state)`` with its BatchNorm statistics.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from mlcomp_tpu_torch.ops.quant import as_tensor, is_quantized_leaf, tree_map_with_path

def from_flax_params(tree, fold: bool = True) -> Dict[str, torch.Tensor]:
    """Flatten a flax-layout params tree (plain or quantized) into the
    port's state: ``<module path>/kernel`` as a folded (m, n) tensor (in
    its flax shape with ``fold=False``, the training layout), or
    ``<module path>/q8`` (m, n) int8 and ``<module path>/scale`` (n,) f32
    for an int8 leaf; ``emb/embedding`` or ``emb/q8``+``emb/scale``;
    norm scales, and the pipelined LM's top-level leaves (its stacked
    ``stages_*`` and ``final_norm``), as they are."""
    state: Dict[str, torch.Tensor] = {}

    def visit(path, leaf):
        key = "/".join(path[:-1])
        if path[-1] == "embedding":
            if is_quantized_leaf(leaf):
                state["emb/q8"] = as_tensor(leaf["q8"])
                state["emb/scale"] = as_tensor(leaf["q8_scale"]).reshape(-1)
            else:
                state["emb/embedding"] = as_tensor(leaf)
            return
        if path[-1] != "kernel":
            state["/".join(path)] = as_tensor(leaf)
            return
        q = as_tensor(leaf["q8"] if is_quantized_leaf(leaf) else leaf)
        # attention kernels contract (d) or (H, dh); every other kernel is 2-D
        n_contract = 2 if path[-2] == "out" and q.dim() == 3 else 1
        m = math.prod(q.shape[:n_contract])
        if is_quantized_leaf(leaf):
            state[f"{key}/q8"] = q.reshape(m, -1)
            state[f"{key}/scale"] = as_tensor(leaf["q8_scale"]).reshape(-1)
        else:
            state[f"{key}/kernel"] = q.reshape(m, -1) if fold else q

    tree_map_with_path(visit, tree)
    return state


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """A nested tree's leaves keyed by their paths joined with ``/`` (a
    flat dict passes through); the inverse of :func:`unflatten`."""
    flat: Dict[str, Any] = {}
    for key, leaf in tree.items():
        path = f"{prefix}{key}"
        if isinstance(leaf, dict):
            flat.update(flatten(leaf, path + "/"))
        else:
            flat[path] = leaf
    return flat


def init_variables(model_cfg: Dict[str, Any], seed: int = 0, device=None,
                   sample_shape=None):
    """A zoo model's ``(params, model_state)``, flax-layout trees with the
    paths, shapes and initialisers of the JAX package's ``init_model``
    (``model_state`` is ``{"batch_stats": ...}`` for the BatchNorm
    families, else ``{}``).  ``sample_shape`` is the input's shape, which
    fixes the leaves that depend on it (an MLP's first kernel, ViT's
    ``pos_emb``); each family has a default.  ``device`` as in
    :func:`init_params`."""
    from mlcomp_tpu_torch.models import create_model

    model = create_model(dict(model_cfg), device="cpu")
    return model.init_variables(seed, device=device, sample_shape=sample_shape)


def init_params(cfg: Dict[str, Any], seed: int = 0, device: Optional[torch.device] = None,
                sample_shape=None):
    """A params tree drawn from ``seed``: a zoo model's (``cfg["name"]`` is
    neither ``transformer_lm`` nor ``moe_lm``; see :func:`init_variables`),
    or else an LM's params tree in the flax layout (unfused projections, as
    training writes them), drawn from ``seed``.  A ``moe_lm`` names its
    layers as flax does: ``MoELayer_{j}`` for every ``moe_every``-th layer
    (attention, ``RMSNorm_0`` and ``moe`` with ``router/kernel`` (d, E),
    ``experts_w1`` (E, d, d_ff) and ``experts_w2`` (E, d_ff, d)), and
    ``DecoderLayer_{j}`` with ``d_ff`` for the others.

    With ``device=None`` the draw is numpy's (``default_rng(seed)``) and the
    leaves are numpy f32 arrays: the CPU tests feed the same tree to both
    packages.  With a ``device`` the draw is a seeded ``torch.Generator``
    on that device, which is fast at full width (a different stream from
    numpy's).  The LM's kernels are normal(0, 1/sqrt(fan_in)); norms are
    ones."""
    name = cfg.get("name", "transformer_lm")
    if name not in ("transformer_lm", "moe_lm", "transformer_lm_pp"):
        return init_variables(cfg, seed, device, sample_shape)[0]
    hidden, heads = cfg["hidden"], cfg["heads"]
    kv_heads = cfg.get("kv_heads") or heads
    moe = name == "moe_lm"
    mlp = (cfg.get("d_ff") if moe else cfg.get("mlp_dim")) or hidden * 4
    vocab = cfg["vocab_size"]
    dh = hidden // heads
    if device is None:
        rng = np.random.default_rng(seed)

        def normal(shape, fan_in):
            return (rng.standard_normal(shape, dtype=np.float32) / np.sqrt(fan_in)).astype(np.float32)

        def ones(n):
            return np.ones((n,), np.float32)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)

        def normal(shape, fan_in):
            return torch.randn(shape, generator=gen, device=device) / math.sqrt(fan_in)

        def ones(n):
            return torch.ones((n,), device=device)

    tree: Dict[str, Any] = {"emb": {"embedding": normal((vocab, hidden), hidden)}}
    if name == "transformer_lm_pp":
        # the pipelined LM: each decoder leaf stacked over the layers
        n = cfg["layers"]
        ones_n = (lambda: np.ones((n, hidden), np.float32)) if device is None else (
            lambda: torch.ones((n, hidden), device=device))
        tree.update({
            "stages_ln1": ones_n(),
            "stages_q": normal((n, hidden, heads * dh), hidden),
            "stages_k": normal((n, hidden, kv_heads * dh), hidden),
            "stages_v": normal((n, hidden, kv_heads * dh), hidden),
            "stages_out": normal((n, heads * dh, hidden), heads * dh),
            "stages_ln2": ones_n(),
            "stages_gate": normal((n, hidden, mlp), hidden),
            "stages_up": normal((n, hidden, mlp), hidden),
            "stages_down": normal((n, mlp, hidden), mlp),
            "final_norm": ones(hidden),
            "lm_head": {"kernel": normal((hidden, vocab), hidden)},
        })
        return tree
    every = int(cfg.get("moe_every", 2)) if moe else 0
    n_dense = n_moe = 0
    for i in range(cfg["layers"]):
        attn = {
            "RMSNorm_0": {"scale": ones(hidden)},
            "q": {"kernel": normal((hidden, heads, dh), hidden)},
            "k": {"kernel": normal((hidden, kv_heads, dh), hidden)},
            "v": {"kernel": normal((hidden, kv_heads, dh), hidden)},
            "out": {"kernel": normal((heads, dh, hidden), heads * dh)},
        }
        if moe and (i + 1) % every == 0:
            e = int(cfg.get("n_experts", 8))
            tree[f"MoELayer_{n_moe}"] = {
                "attn": attn,
                "RMSNorm_0": {"scale": ones(hidden)},
                "moe": {
                    "router": {"kernel": normal((hidden, e), hidden)},
                    "experts_w1": normal((e, hidden, mlp), hidden),
                    "experts_w2": normal((e, mlp, hidden), mlp),
                },
            }
            n_moe += 1
            continue
        tree[f"DecoderLayer_{n_dense}"] = {
            "attn": attn,
            "RMSNorm_0": {"scale": ones(hidden)},
            "gate": {"kernel": normal((hidden, mlp), hidden)},
            "up": {"kernel": normal((hidden, mlp), hidden)},
            "down": {"kernel": normal((mlp, hidden), mlp)},
        }
        n_dense += 1
    tree["RMSNorm_0"] = {"scale": ones(hidden)}
    tree["lm_head"] = {"kernel": normal((hidden, vocab), hidden)}
    return tree


def save_npz(path: str, tree) -> None:
    """Save a params tree as ``.npz`` (keys are flax paths joined by ``/``;
    a quantized leaf stores ``<path>/q8`` and ``<path>/q8_scale``)."""
    flat: Dict[str, np.ndarray] = {}

    def visit(p, leaf):
        if is_quantized_leaf(leaf):
            for k in ("q8", "q8_scale"):
                flat["/".join(p + (k,))] = np.asarray(as_tensor(leaf[k]).cpu())
        else:
            flat["/".join(p)] = np.asarray(as_tensor(leaf).cpu())

    tree_map_with_path(visit, tree)
    np.savez(path, **flat)


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """A nested tree from leaves keyed by paths joined with ``/``."""
    tree: Dict[str, Any] = {}
    for key, leaf in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    return tree


def load_npz(path: str):
    """Inverse of :func:`save_npz`: a nested dict of numpy arrays."""
    with np.load(path) as z:
        return unflatten({key: z[key] for key in z.files})
