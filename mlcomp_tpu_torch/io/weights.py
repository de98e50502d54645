"""Weights carried across from the JAX package, and the ``.npz`` format of
the CLI's ``--ckpt``.

Trees keep the flax layout: nested dicts keyed by flax module names
(``DecoderLayer_3/attn/q/kernel`` is (d, H, dh), ``attn/out/kernel``
(H, dh, d)), leaves numpy arrays or tensors, quantized leaves
``{"q8", "q8_scale"}``.  :func:`from_flax_params` flattens such a tree
into the state ``TransformerLM.load_state`` takes, folding every
projection to its 2-D (m, n) operand.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from mlcomp_tpu_torch.ops.quant import as_tensor, is_quantized_leaf, tree_map_with_path

def from_flax_params(tree) -> Dict[str, torch.Tensor]:
    """Flatten a flax-layout params tree (plain or quantized) into the
    port's state: ``<module path>/kernel`` as a folded (m, n) tensor, or
    ``<module path>/q8`` (m, n) int8 and ``<module path>/scale`` (n,) f32
    for an int8 leaf; ``emb/embedding`` or ``emb/q8``+``emb/scale``;
    norm scales as they are."""
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
            state[f"{key}/kernel"] = q.reshape(m, -1)

    tree_map_with_path(visit, tree)
    return state


def init_params(cfg: Dict[str, Any], seed: int = 0, device: Optional[torch.device] = None):
    """A ``transformer_lm`` params tree in the flax layout (unfused
    projections, as training writes them), drawn from ``seed``.

    With ``device=None`` the draw is numpy's (``default_rng(seed)``) and the
    leaves are numpy f32 arrays: the CPU tests feed the same tree to both
    packages.  With a ``device`` the draw is a seeded ``torch.Generator``
    on that device, which is fast at full width (a different stream from
    numpy's).  Kernels are normal(0, 1/sqrt(fan_in)); norms are ones."""
    hidden, heads = cfg["hidden"], cfg["heads"]
    kv_heads = cfg.get("kv_heads") or heads
    mlp = cfg.get("mlp_dim") or hidden * 4
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
    for i in range(cfg["layers"]):
        tree[f"DecoderLayer_{i}"] = {
            "attn": {
                "RMSNorm_0": {"scale": ones(hidden)},
                "q": {"kernel": normal((hidden, heads, dh), hidden)},
                "k": {"kernel": normal((hidden, kv_heads, dh), hidden)},
                "v": {"kernel": normal((hidden, kv_heads, dh), hidden)},
                "out": {"kernel": normal((heads, dh, hidden), heads * dh)},
            },
            "RMSNorm_0": {"scale": ones(hidden)},
            "gate": {"kernel": normal((hidden, mlp), hidden)},
            "up": {"kernel": normal((hidden, mlp), hidden)},
            "down": {"kernel": normal((mlp, hidden), mlp)},
        }
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


def load_npz(path: str):
    """Inverse of :func:`save_npz`: a nested dict of numpy arrays."""
    tree: Dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = z[key]
    return tree
