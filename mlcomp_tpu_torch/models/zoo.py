"""The model zoo's shared pieces: flax's naming, initialisers and layers.

Each zoo family (``mlp``, ``mnist_cnn``, ``resnet*``, ``unet``, ``bert*``,
``vit*``) ports a flax module of mlcomp_tpu/models/.  Its forward is
written in flax's compact style against a :class:`Scope` that names every
leaf as flax does (``BottleneckBlock_3/Conv_1/kernel``: the class name and
a counter per class inside its parent, or an explicit name), so the
weights are the flax tree itself: ``params`` and ``batch_stats`` map flax
paths to tensors in their flax shapes (Conv kernels HWIO, ``DenseGeneral``
kernels (d, H, dh) and (H, dh, d)), and the layers below read them in
those shapes (a conv permutes its kernel to OIHW, a dense folds its
kernel to 2-D).  Activations are NHWC, as in the JAX package; a conv runs
``F.conv2d`` on the channels-last NCHW view of the same memory.

What flax does and torch does not by default, kept here:

- ``SAME`` padding is flax's: ``pad_total = max((ceil(n/s) - 1) s + k - n,
  0)``, ``total // 2`` before and the rest after (asymmetric for a 3x3
  stride-2 or a 2x2 stride-1 conv on even sizes);
- BatchNorm: statistics in f32 with the fast variance E[x^2] - E[x]^2 (the
  biased one, clipped at 0), eps 1e-5 in the zoo, running statistics
  updated as ``ra = momentum ra + (1 - momentum) batch`` with the *biased*
  batch variance;
- LayerNorm and GroupNorm: eps 1e-6 by default, f32 statistics (the fast
  variance), output in the layer's dtype;
- a Dense or Conv casts its input and kernel to the layer's dtype (the
  heads compute in f32); the norms' scale and bias stay f32.

The initialisers are flax's: ``lecun_normal`` kernels (a normal truncated
to +-2 standard deviations, scaled by sqrt(1/fan_in) / .87962566103423978),
zero biases, ones and zeros for norms, and ``Embed``'s normal with
variance 1/features.  :meth:`ZooModel.init_variables` finds every leaf's
shape as ``flax.init`` does, by running the forward once on a sample input
(on the ``meta`` device: no memory, no arithmetic), and draws the leaves
in creation order from a numpy or torch generator.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mlcomp_tpu_torch.parallel import collectives as col
from mlcomp_tpu_torch.parallel.mesh import current_mesh

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# the standard deviation of a standard normal truncated to (-2, 2)
TRUNC_STD = 0.87962566103423978

ZEROS = ("zeros",)
ONES = ("ones",)


def lecun(fan_in: int) -> Tuple[str, float]:
    """flax's ``lecun_normal``: truncated normal, variance 1/fan_in."""
    return ("trunc", math.sqrt(1.0 / fan_in) / TRUNC_STD)


def normal(std: float) -> Tuple[str, float]:
    return ("normal", float(std))


def dtype_of(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {name!r}")
    return DTYPES[name]


class Scope:
    """A module's place in the flax tree.  ``sub(kind)`` names a child as
    flax names an unnamed submodule (``f"{kind}_{n}"``, n counting that
    kind inside this scope); ``sub(kind, name)`` takes an explicit name,
    which counts nothing."""

    def __init__(self, model: "ZooModel", path: Tuple[str, ...] = ()):
        self.model, self.path = model, path
        self._counts: Dict[str, int] = {}

    def sub(self, kind: str, name: Optional[str] = None) -> "Scope":
        if name is None:
            n = self._counts.get(kind, 0)
            self._counts[kind] = n + 1
            name = f"{kind}_{n}"
        return Scope(self.model, self.path + (name,))

    def param(self, name: str, shape: Sequence[int], init) -> torch.Tensor:
        return self.model._leaf("params", "/".join(self.path + (name,)), shape, init)

    def stat(self, name: str, shape: Sequence[int], init) -> torch.Tensor:
        return self.model._leaf("batch_stats", "/".join(self.path + (name,)), shape, init)

    @property
    def discovering(self) -> bool:
        return self.model._specs is not None


class ZooModel(nn.Module):
    """Base of the zoo families.  Subclasses set ``self.dtype`` and write
    ``apply(scope, x, train)``; ``forward(x)`` runs it in the module's mode
    (``model.train()`` updates the BatchNorm statistics in place,
    ``model.eval()`` reads them).

    ``params`` and ``batch_stats`` map flax paths to tensors; after
    :meth:`load_variables` with ``train=True`` every parameter is an f32
    ``nn.Parameter`` that the trainer updates in place."""

    # the sample input's shape and dtype for shape discovery, when the
    # caller gives no shape
    default_sample_shape: Tuple[int, ...] = ()
    sample_dtype = torch.float32

    def __init__(self, device=None):
        super().__init__()
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.params: Dict[str, torch.Tensor] = {}
        self.batch_stats: Dict[str, torch.Tensor] = {}
        self._specs: Optional[List[Tuple[str, str, Tuple[int, ...], Any]]] = None

    # ---- the forward
    def apply(self, scope: Scope, x: torch.Tensor, train: bool) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(Scope(self), x, self.training and self._specs is None)

    def _leaf(self, collection: str, key: str, shape, init) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        if self._specs is not None:
            self._specs.append((collection, key, shape, init))
            return torch.zeros(shape, device="meta")
        store = self.params if collection == "params" else self.batch_stats
        try:
            return store[key]
        except KeyError:
            raise KeyError(f"{type(self).__name__}: no {collection} leaf {key!r} "
                           "(load the weights first: load_variables)") from None

    # ---- the weights
    def leaf_specs(self, sample_shape: Optional[Sequence[int]] = None):
        """``[(collection, flax path, shape, init)]`` in creation order, from
        one forward on a ``meta`` sample of ``sample_shape`` (flax's init
        runs with ``train=False``)."""
        shape = tuple(sample_shape) if sample_shape is not None else self.default_sample_shape
        x = torch.zeros(shape, device="meta", dtype=self.sample_dtype)
        self._specs = []
        try:
            with torch.no_grad():
                self.apply(Scope(self), x, False)
            return list(self._specs)
        finally:
            self._specs = None

    def init_variables(self, seed: int = 0, device=None,
                       sample_shape: Optional[Sequence[int]] = None):
        """``(params, model_state)`` as flax-layout trees drawn from
        ``seed``: ``model_state`` is ``{"batch_stats": tree}`` or ``{}``.
        With ``device=None`` the leaves are numpy f32 arrays from
        ``np.random.default_rng(seed)`` (the CPU tests feed one tree to both
        packages); with a device they are tensors drawn there by a seeded
        ``torch.Generator`` (another stream than numpy's)."""
        from mlcomp_tpu_torch.io.weights import unflatten

        specs = self.leaf_specs(sample_shape)
        if device is None:
            rng = np.random.default_rng(seed)

            def draw(shape, init):
                kind = init[0]
                if kind == "zeros":
                    return np.zeros(shape, np.float32)
                if kind == "ones":
                    return np.ones(shape, np.float32)
                z = rng.standard_normal(shape, dtype=np.float32)
                if kind == "trunc":
                    bad = np.abs(z) > 2.0
                    while bad.any():
                        z[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
                        bad = np.abs(z) > 2.0
                return (z * np.float32(init[1])).astype(np.float32)
        else:
            device = torch.device(device)
            gen = torch.Generator(device=device).manual_seed(seed)

            def draw(shape, init):
                kind = init[0]
                if kind == "zeros":
                    return torch.zeros(shape, device=device)
                if kind == "ones":
                    return torch.ones(shape, device=device)
                t = torch.empty(shape, device=device)
                if kind == "trunc":
                    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
                else:
                    t.normal_(generator=gen)
                return t.mul_(init[1])

        flat: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
        for collection, key, shape, init in specs:
            flat[collection][key] = draw(shape, init)
        params = unflatten(flat["params"])
        state = {"batch_stats": unflatten(flat["batch_stats"])} if flat["batch_stats"] else {}
        return params, state

    def load_variables(self, params, model_state=None, train: bool = False) -> None:
        """Take a flax-layout ``params`` tree (nested or flat by path; numpy
        arrays or tensors) and ``model_state`` (``{"batch_stats": tree}``).
        With ``train`` each parameter becomes an f32 ``nn.Parameter`` with
        storage of its own; the statistics are always f32 copies on the
        model's device (train steps update them in place)."""
        from mlcomp_tpu_torch.io.weights import flatten
        from mlcomp_tpu_torch.ops.quant import as_tensor

        dev = self.device
        flat = flatten(params)
        stats = flatten((model_state or {}).get("batch_stats", {}))
        out: Dict[str, torch.Tensor] = {}
        for k, v in flat.items():
            t = as_tensor(v).to(dev, torch.float32, copy=True)
            out[k] = nn.Parameter(t) if train else t
        self.params = out
        self.batch_stats = {k: as_tensor(v).to(dev, torch.float32, copy=True)
                            for k, v in stats.items()}

    def flax_params(self) -> Dict[str, torch.Tensor]:
        """Every parameter by its flax path: the trainer's parameter tree."""
        return dict(self.params)

    def model_state(self) -> Dict[str, torch.Tensor]:
        """The BatchNorm statistics by ``batch_stats/<flax path>``: the
        live tensors that a train-mode forward updates."""
        return {f"batch_stats/{k}": v for k, v in self.batch_stats.items()}


# ---- layers over NHWC activations (flax.linen semantics)

def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv(scope: Scope, x: torch.Tensor, features: int, kernel: Tuple[int, int],
         strides: Tuple[int, int] = (1, 1), padding: Any = "SAME", use_bias: bool = True,
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``nn.Conv``: x (B, H, W, C) -> (B, H', W', features)."""
    b, h, w, cin = x.shape
    kh, kw = kernel
    sh, sw = strides
    weight = scope.param("kernel", (kh, kw, cin, features), lecun(kh * kw * cin))
    bias = scope.param("bias", (features,), ZEROS) if use_bias else None
    if padding == "SAME":
        ph, pw = _same_pads(h, kh, sh), _same_pads(w, kw, sw)
    elif padding == "VALID":
        ph = pw = (0, 0)
    else:
        ph, pw = tuple(padding[0]), tuple(padding[1])
    xc = x.to(dtype).permute(0, 3, 1, 2)      # NCHW view, channels-last memory
    if ph[0] == ph[1] and pw[0] == pw[1]:
        pad = (ph[0], pw[0])
    else:
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
        pad = (0, 0)
    y = F.conv2d(xc, weight.to(dtype).permute(3, 2, 0, 1),
                 None if bias is None else bias.to(dtype), (sh, sw), pad)
    return y.permute(0, 2, 3, 1)


def dense(scope: Scope, x: torch.Tensor, features: Sequence[int] | int,
          dtype: torch.dtype, n_contract: int = 1, use_bias: bool = True) -> torch.Tensor:
    """``nn.Dense`` / ``nn.DenseGeneral``: contract the trailing
    ``n_contract`` axes of x with a kernel of shape (contracted..., features...)."""
    feats = (features,) if isinstance(features, int) else tuple(features)
    contracted = tuple(x.shape[x.dim() - n_contract:])
    m, n = math.prod(contracted), math.prod(feats)
    kernel = scope.param("kernel", contracted + feats, lecun(m))
    bias = scope.param("bias", feats, ZEROS) if use_bias else None
    lead = x.shape[: x.dim() - n_contract]
    y = x.reshape(-1, m).to(dtype) @ kernel.reshape(m, n).to(dtype)
    if bias is not None:
        y = y + bias.reshape(n).to(dtype)
    return y.reshape(*lead, *feats)


def embed(scope: Scope, ids: torch.Tensor, num: int, features: int,
          dtype: torch.dtype) -> torch.Tensor:
    """``nn.Embed``: the table cast to ``dtype``, then gathered."""
    table = scope.param("embedding", (num, features), normal(math.sqrt(1.0 / features)))
    return F.embedding(ids, table.to(dtype))


def _normalize(x, mean, var, scale, bias, eps: float, dtype) -> torch.Tensor:
    # flax's _normalize: (x - mean) * (rsqrt(var + eps) * scale) + bias in f32
    mul = torch.rsqrt(var + eps) * scale
    return ((x.float() - mean) * mul + bias).to(dtype)


def _fast_stats(x32: torch.Tensor, dims, keepdim: bool = True):
    mean = x32.mean(dims, keepdim=keepdim)
    mean2 = (x32 * x32).mean(dims, keepdim=keepdim)
    return mean, torch.clamp_min(mean2 - mean * mean, 0.0)


def layer_norm(scope: Scope, x: torch.Tensor, dtype: torch.dtype,
               eps: float = 1e-6) -> torch.Tensor:
    """``nn.LayerNorm`` over the last axis (f32 statistics, flax's eps)."""
    d = x.shape[-1]
    scale = scope.param("scale", (d,), ONES)
    bias = scope.param("bias", (d,), ZEROS)
    mean, var = _fast_stats(x.float(), -1)
    return _normalize(x, mean, var, scale, bias, eps, dtype)


def group_norm(scope: Scope, x: torch.Tensor, groups: int, dtype: torch.dtype,
               eps: float = 1e-6) -> torch.Tensor:
    """``nn.GroupNorm(num_groups=groups)`` on NHWC: statistics per batch row
    and group over H, W and the group's channels."""
    b, h, w, c = x.shape
    if groups <= 0 or c % groups:
        raise ValueError(f"Number of groups ({groups}) does not divide the number of "
                         f"channels ({c}).")
    scale = scope.param("scale", (c,), ONES)
    bias = scope.param("bias", (c,), ZEROS)
    g = x.float().reshape(b, h, w, groups, c // groups)
    mean, var = _fast_stats(g, (1, 2, 4))
    mean = mean.expand(b, 1, 1, groups, c // groups).reshape(b, 1, 1, c)
    var = var.expand(b, 1, 1, groups, c // groups).reshape(b, 1, 1, c)
    return _normalize(x, mean, var, scale, bias, eps, dtype)


class _BatchNormTrain(torch.autograd.Function):
    """Train-mode BatchNorm over every axis but the last, in f32: the
    forward saves x and the per-channel mean and 1/std only (not f32 copies
    of the activation); the backward is the closed form of flax's
    expression's gradient (the fast variance's gradient equals the
    two-pass one's: d var / d x_i = 2 (x_i - mean) / N).

    Over ``groups`` (the data axes of a Trainer's mesh) the statistics are
    the global batch's, as the JAX step's ``nn.BatchNorm`` takes them under
    ``jit``: each channel's sum of x and of x^2 and the row count, summed
    over the groups in one all-reduce each, give flax's fast variance (the
    mean of squares less the square of the mean, clamped at 0).  The
    backward sums dbias and dscale the same way before they enter dx, over
    the global N, and returns the rank's own parameter gradients: the
    Trainer averages those over dp x fsdp, and the rank's dx, a gradient of
    every rank's loss, comes out at the data ranks' count times the global
    loss's, which that average takes back."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float, dtype, groups):
        c = x.shape[-1]
        x32 = x.float().reshape(-1, c)
        if not groups:
            mean, var = _fast_stats(x32, 0, keepdim=False)
            n = x32.shape[0]
        else:
            sums = torch.cat([x32.sum(0), (x32 * x32).sum(0), x32.new_full((1,), x32.shape[0])])
            for g in groups:
                col.all_reduce_(sums, g)
            n = sums[2 * c]
            mean = sums[:c] / n
            var = torch.clamp_min(sums[c:2 * c] / n - mean * mean, 0.0)
        rstd = torch.rsqrt(var + eps)
        y = ((x32 - mean) * (rstd * scale) + bias).to(dtype).reshape(x.shape)
        ctx.save_for_backward(x, mean, rstd, scale)
        ctx.groups, ctx.n = groups, n
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, rstd, scale = ctx.saved_tensors
        c = x.shape[-1]
        dy32 = dy.float().reshape(-1, c)
        xhat = (x.float().reshape(-1, c) - mean) * rstd
        dbias = dy32.sum(0)
        dscale = (dy32 * xhat).sum(0)
        dbias_n, dscale_n, n = dbias, dscale, ctx.n
        if ctx.groups:
            sums = torch.cat([dbias, dscale])
            for g in ctx.groups:
                col.all_reduce_(sums, g)
            dbias_n, dscale_n = sums[:c], sums[c:]
        dx = (dy32 - dbias_n / n - xhat * (dscale_n / n)) * (rstd * scale)
        return dx.to(x.dtype).reshape(x.shape), dscale, dbias, None, None, None


def batch_norm(scope: Scope, x: torch.Tensor, train: bool, dtype: torch.dtype,
               momentum: float = 0.9, eps: float = 1e-5, scale_init=ONES) -> torch.Tensor:
    """``nn.BatchNorm(momentum, epsilon, dtype, param_dtype=f32)`` over NHWC.
    In train mode the batch statistics normalise and the running ones are
    updated in place (biased variance, flax's momentum); under a Trainer's
    mesh both are the global batch's (:class:`_BatchNormTrain`)."""
    c = x.shape[-1]
    ra_mean = scope.stat("mean", (c,), ZEROS)
    ra_var = scope.stat("var", (c,), ONES)
    scale = scope.param("scale", (c,), scale_init)
    bias = scope.param("bias", (c,), ZEROS)
    if not train:
        return _normalize(x, ra_mean, ra_var, scale, bias, eps, dtype)
    y, mean, var = _BatchNormTrain.apply(x, scale, bias, eps, dtype,
                                         col.data_groups(current_mesh()))
    with torch.no_grad():
        ra_mean.copy_(momentum * ra_mean + (1 - momentum) * mean)
        ra_var.copy_(momentum * ra_var + (1 - momentum) * var)
    return y


def max_pool(x: torch.Tensor, window: int, stride: int, padding: int = 0) -> torch.Tensor:
    """``nn.max_pool`` (padding with -inf) on NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, padding).permute(0, 2, 3, 1)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``nn.gelu``: the tanh approximation (torch's default is exact)."""
    return F.gelu(x, approximate="tanh")
