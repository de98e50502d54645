"""Parameter/state sharding: fsdp + tensor parallelism, one rule pass.

The counterpart of mlcomp_tpu/parallel/sharding.py.  ``TP_RULES`` and
:func:`spec_for` are the JAX package's, word for word: tp pattern rules
first (heads of q/k/v and out, the MLP width, the vocabulary of
``lm_head``, the hidden width of ``emb``, experts over ``ep``, pipeline
stages over ``pp``), then fsdp on the largest remaining divisible
dimension of every leaf of at least ``fsdp_min_size`` elements.

In the port a placement becomes state: :func:`make_sharded_state` holds
every parameter, and through ``zeros_like`` every optimizer moment, as a
``DTensor`` on the mesh (its axes wider than 1), ``Shard(d)`` on the mesh
dimension
``spec_for`` names for tensor dimension d and ``Replicate()`` elsewhere.
Each rank holds only its shard on the device, and the optimizer's
reductions (the global norm, adafactor's factored means, the trust
ratios) keep their unsharded meaning through DTensor.

The model computes on plain tensors, never DTensors, so that the
hand-written kernels see ordinary local memory (the port's counterpart
of a ``shard_map`` island).  :class:`ShardedParams` binds, for each
step, a compute view of every parameter into the model:

- gathered over ``fsdp`` (all-gather; the gradient is reduce-scattered),
  and over ``ep`` (all-gather; the gradient is the rank's chunk: every
  ep rank computes the same tokens);
- over ``tp`` the rank's shard where the model computes that layer
  tensor-parallel (``model.tp_local_paths``: column-parallel q/k/v,
  gate/up and ``lm_head``, row-parallel out/down, the embedding's hidden
  slice, with the region edges of ``parallel/collectives``; the module
  holding each such shard gets the tp group as ``tp_group``, which its
  forward reads), gathered elsewhere;
- over ``pp`` the rank's stages (``pipeline_lm``).

After the backward every gradient is summed over the axes the model
splits its work over (``model.split_axes()``: ``sp`` for a sequence-
sharded LM, ``pp`` for the pipeline), averaged over ``dp`` x ``fsdp``,
and handed to the optimizer as a DTensor with the parameter's placement.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from mlcomp_tpu_torch.parallel import collectives as col
from mlcomp_tpu_torch.parallel.mesh import AXES, axis_size, mesh_shape

# (path regex, ((dim, axis), ...)) — matched against "/".join(path keys).
# Dims index into the *leaf* shape; negative dims count from the end.
# Patterns mirror the model zoo's naming (models/transformer.py, bert.py,
# moe.py). Each rule may pin several dims (e.g. MoE: experts over ep AND
# the ffn dim over tp).
TP_RULES: List[Tuple[str, Tuple[Tuple[int, str], ...]]] = [
    (r"(^|/)(q|k|v)/kernel$", ((-2, "tp"),)),   # (hidden, heads, d_head): heads
    (r"(^|/)out/kernel$", ((0, "tp"),)),        # (heads, d_head, hidden): heads
    (r"(^|/)(gate|up)/kernel$", ((-1, "tp"),)), # (hidden, mlp): mlp
    (r"(^|/)down/kernel$", ((0, "tp"),)),       # (mlp, hidden): mlp
    (r"(^|/)emb/embedding$", ((-1, "tp"),)),    # (vocab, hidden): hidden
    (r"(^|/)lm_head/kernel$", ((-1, "tp"),)),   # (hidden, vocab): vocab
    (r"(^|/)(query|key|value)/kernel$", ((-2, "tp"),)),  # bert naming
    (r"(^|/)attn_out/kernel$", ((0, "tp"),)),
    (r"(^|/)(mlp_in|intermediate)/kernel$", ((-1, "tp"),)),
    (r"(^|/)(mlp_out|output)/kernel$", ((0, "tp"),)),
    # MoE stacked expert weights (E, d, f)/(E, f, d): experts over ep,
    # ffn dim over tp
    (r"(^|/)experts_w1$", ((0, "ep"), (-1, "tp"))),
    (r"(^|/)experts_w2$", ((0, "ep"), (-2, "tp"))),
    (r"(^|/)router/kernel$", ()),               # tiny; keep replicated
    # pipelined LM stacked stage params (V, ...): one virtual-stage slice
    # per pp device (models/pipeline_lm.py)
    (r"(^|/)stages_[^/]+$", ((0, "pp"),)),
]


def _path_str(path) -> str:
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "name"):
            parts.append(str(p.name))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        else:
            parts.append(str(p))
    return "/".join(parts)


def tp_dim(path: str, ndim: int) -> Optional[int]:
    """The dim of an ``ndim``-d leaf at ``path`` that ``TP_RULES`` shards
    over ``tp`` (counted from 0), or None: the Megatron role of a
    projection, row-parallel when the dim is in its contraction."""
    for pat, dims in TP_RULES:
        if re.search(pat, path):
            return next((dim % ndim for dim, axis in dims if axis == "tp"), None)
    return None


def spec_for(
    path: str,
    shape: Sequence[int],
    mesh,
    tp_rules: Optional[List[Tuple[str, int, str]]] = None,
    fsdp_min_size: int = 2**14,
) -> tuple:
    """Placement of one leaf (the entries of the JAX ``PartitionSpec``):
    tp pattern first, fsdp default after.

    fsdp shards the largest *remaining* divisible dim, so a tp-sharded
    matrix still gets fsdp on its other dimension when both axes are >1
    (the standard 2D layout). Leaves smaller than ``fsdp_min_size``
    elements (biases, norm scales, BN stats) stay replicated — gathering
    them costs more than storing them.
    """
    if not shape:
        return ()
    shape_of = mesh_shape(mesh)
    ndim = len(shape)
    spec: List = [None] * ndim
    for pat, dims in tp_rules if tp_rules is not None else TP_RULES:
        if re.search(pat, path):
            for dim, axis in dims:
                n = shape_of.get(axis, 1)
                d = dim % ndim
                if n > 1 and shape[d] % n == 0 and spec[d] is None:
                    spec[d] = axis
            break
    fsdp = shape_of.get("fsdp", 1)
    size = 1
    for s in shape:
        size *= s
    if fsdp > 1 and ndim >= 2 and size >= fsdp_min_size:
        # largest unclaimed dim divisible by the fsdp axis size
        cands = [d for d in range(ndim) if spec[d] is None and shape[d] % fsdp == 0]
        if cands:
            d = max(cands, key=lambda d: shape[d])
            spec[d] = "fsdp"
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def state_shardings(shapes: Dict[str, Sequence[int]], mesh, tp_rules=None) -> Dict[str, tuple]:
    """``spec_for`` of every leaf of a state given by flax path and shape
    (or tensor): optimizer moments carry the parameter's path, so one rule
    pass places parameters and moments alike."""
    return {k: spec_for(k, tuple(getattr(s, "shape", s)), mesh, tp_rules)
            for k, s in shapes.items()}


def placements(spec: tuple, mesh) -> list:
    """DTensor placements on ``mesh`` (one a mesh dimension, AXES order)
    of a ``spec_for`` placement."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, a in enumerate(spec) if a == axis or (isinstance(a, tuple) and axis in a)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def _local_chunk(full: torch.Tensor, mesh, places) -> torch.Tensor:
    """This rank's shard of a full tensor under ``places``."""
    t = full
    for i, p in enumerate(places):
        if p.is_shard():
            n = mesh.size(i)
            t = t.chunk(n, p.dim)[mesh.get_local_rank(i)]
    return t


def distribute(full: torch.Tensor, mesh, spec: tuple, device):
    """A DTensor on ``mesh`` placed by ``spec``: each rank keeps its shard
    of ``full`` (a host tensor every rank holds) on ``device``."""
    from torch.distributed.tensor import DTensor

    places = placements(spec, mesh)
    local = _local_chunk(full, mesh, places).to(device, copy=True).contiguous()
    return DTensor.from_local(local, mesh, places, run_check=False,
                              shape=full.shape, stride=full.contiguous().stride())


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The unsharded value; for a DTensor a collective on every rank
    (partial sums all-reduced, then the shards gathered through
    ``parallel/collectives``)."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate

    if any(p.is_partial() for p in t.placements):
        t = t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p
                                           for p in t.placements])
    local, mesh = t.to_local(), t.device_mesh
    for i, p in enumerate(t.placements):
        if p.is_shard():
            local = col.gather_dim(local, mesh.get_group(i), p.dim)
    return local


def full_tree(obj):
    """:func:`full_tensor` over a nested dict/list/tuple."""
    if isinstance(obj, torch.Tensor):
        return full_tensor(obj)
    if isinstance(obj, dict):
        return {k: full_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(full_tree(v) for v in obj)
    return obj


def restore_like(current, saved):
    """``saved`` (full tensors) placed as ``current``: a DTensor leaf
    keeps its shard of the saved value (a Partial placement comes back
    replicated), a plain tensor moves to the current one's device."""
    if isinstance(current, torch.Tensor):
        if not is_dtensor(current):
            return saved.to(current.device)
        from torch.distributed.tensor import Replicate

        places = [Replicate() if p.is_partial() else p for p in current.placements]
        mesh = current.device_mesh
        local = _local_chunk(saved, mesh, places).to(current.to_local().device).contiguous()
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(local, mesh, places, run_check=False,
                                  shape=saved.shape, stride=saved.contiguous().stride())
    if isinstance(current, dict):
        return {k: restore_like(current[k], saved[k]) if k in current else saved[k]
                for k in saved}
    if isinstance(current, (list, tuple)):
        return type(current)(restore_like(c, s) for c, s in zip(current, saved))
    return saved


def load_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy a full tensor into ``dst`` in place: a DTensor takes its own
    shard (a Partial placement is restored as its replicated value)."""
    if not is_dtensor(dst):
        dst.copy_(src)
        return
    if any(p.is_partial() for p in dst.placements):
        raise ValueError("cannot load into a DTensor with a Partial placement")
    dst.to_local().copy_(_local_chunk(src, dst.device_mesh, dst.placements))


def state_mesh(mesh):
    """The sub-mesh of the axes wider than 1 (``dp`` alone when none is),
    which the state's DTensors live on: DTensor's sharding propagation
    enumerates every mesh dimension, and size-1 ones only cost time."""
    wide = tuple(a for a in mesh.mesh_dim_names if axis_size(mesh, a) > 1)
    return mesh[wide if wide else ("dp",)]


def make_sharded_state(model, tx, mesh, ema_decay: float = 0.0, tp_rules=None):
    """A :class:`~mlcomp_tpu_torch.train.state.TrainState` over ``model``
    whose parameters (and so the optimizer moments and the EMA) are
    DTensors placed by :func:`spec_for`; returns ``(state, specs)``.

    The model's parameters must hold the full weights on the host (each
    rank draws the same weights from the seed); they leave the model,
    which from here on computes on the views :class:`ShardedParams` binds.
    The model's buffers (BatchNorm statistics) move to the mesh's device."""
    from mlcomp_tpu_torch.train.state import TrainState

    device = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")
    full = dict(model.flax_params())
    specs = state_shardings(full, mesh, tp_rules)
    smesh = state_mesh(mesh)
    params = {k: distribute(p.detach(), smesh, specs[k], device) for k, p in full.items()}
    binding = ShardedParams(model, full, mesh, specs)
    binding.detach_params()
    model.to(device)
    if hasattr(model, "batch_stats"):
        # the zoo keeps its BatchNorm statistics in a plain dict
        model.batch_stats = {k: v.to(device) for k, v in model.batch_stats.items()}
    model_state = model.model_state() if hasattr(model, "model_state") else {}
    state = TrainState(model, params, tx, ema_decay, model_state)
    state.binding = binding
    return state, specs


def _owner(model, module_path: str):
    parts = module_path.split(".")
    mod = model
    for p in parts[:-1]:
        mod = getattr(mod, p)
    return mod, parts[-1]


class ShardedParams:
    """Binds per-step compute views of DTensor parameters into a model and
    turns the views' gradients into DTensor gradients (see the module
    docstring)."""

    def __init__(self, model, params: Dict[str, torch.Tensor], mesh, specs: Dict[str, tuple]):
        self.model, self.mesh, self.specs = model, mesh, specs
        if isinstance(getattr(model, "params", None), dict):
            # the zoo: parameters by flax path in the model's ``params`` dict
            self.owner = {k: (model.params, k) for k in params}
        else:
            names = {id(p): n for n, p in model.named_parameters(remove_duplicate=False)}
            self.owner = {k: _owner(model, names[id(p)]) for k, p in params.items()}
        tp = axis_size(mesh, "tp")
        local = model.tp_local_paths(tp) if hasattr(model, "tp_local_paths") else set()
        self.tp_local = {k for k in params if k in local}
        for k in self.tp_local:
            # the one record of which layers compute tensor-parallel
            self.owner[k][0].tp_group = mesh.get_group("tp")
        self.split_axes = set(model.split_axes()) if hasattr(model, "split_axes") else set()
        self.n_data = axis_size(mesh, "dp") * axis_size(mesh, "fsdp")

    def detach_params(self) -> None:
        """Take the full parameters out of the model (it computes on views)."""
        for mod, name in self.owner.values():
            self._set(mod, name, None)

    @staticmethod
    def _set(mod, name: str, value) -> None:
        if isinstance(mod, dict):
            mod[name] = value
            return
        if name in mod._parameters:
            del mod._parameters[name]
        setattr(mod, name, value)

    def _dims(self, key: str) -> Dict[str, int]:
        """``{axis: tensor dim}`` of the parameter's sharded axes."""
        return {a: d for d, a in enumerate(self.specs[key]) if a is not None}

    def _gathered(self, key: str) -> Dict[str, int]:
        """The sharded axes whose shards the compute view gathers."""
        out = {}
        for a, d in self._dims(key).items():
            if a == "pp" or (a == "tp" and key in self.tp_local):
                continue
            out[a] = d
        return out

    def view(self, key: str, p) -> torch.Tensor:
        t = p.to_local()
        for a, d in self._gathered(key).items():
            t = col.gather_dim(t, self.mesh.get_group(a), d)
        return t

    def bind(self, params: Dict[str, torch.Tensor], requires_grad: bool) -> Dict[str, torch.Tensor]:
        """Set every parameter's compute view into the model; returns the
        views (leaves of this step's autograd graph when ``requires_grad``)."""
        views = {}
        with torch.no_grad():
            for k, p in params.items():
                v = self.view(k, p).detach()
                if requires_grad:
                    v.requires_grad_(True)
                self._set(*self.owner[k], v)
                views[k] = v
        return views

    def reduce_grad(self, key: str, g: torch.Tensor, p) -> torch.Tensor:
        """A view's gradient as a DTensor gradient of the parameter."""
        from torch.distributed.tensor import DTensor

        m = self.mesh
        dims = self._dims(key)
        gathered = self._gathered(key)
        for a in ("ep", "tp"):
            # every rank of these axes computed the same tokens: the
            # gradient of a gathered shard is the rank's own chunk
            if a in gathered:
                g = col.chunk_of(g, m.get_group(a), gathered[a])
        for a in ("sp", "pp"):
            if a in self.split_axes and axis_size(m, a) > 1 and a not in dims:
                col.all_reduce_(g, m.get_group(a))
        if axis_size(m, "fsdp") > 1:
            if "fsdp" in dims:
                g = col.reduce_scatter_dim(g, m.get_group("fsdp"), dims["fsdp"])
            else:
                col.all_reduce_(g, m.get_group("fsdp"))
        if axis_size(m, "dp") > 1:
            col.all_reduce_(g, m.get_group("dp"))
        if self.n_data > 1:
            g = g / self.n_data
        return DTensor.from_local(g.contiguous(), p.device_mesh, p.placements, run_check=False,
                                  shape=p.shape, stride=p.stride())

    def reduce_grads(self, grads: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor]):
        """The views' gradients (by flax path) as the parameters' DTensor
        gradients."""
        return {k: self.reduce_grad(k, g, params[k]) for k, g in grads.items()}

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Rows computed by every (dp, fsdp) coordinate, concatenated in
        the global batch's order (dp major)."""
        for a in ("fsdp", "dp"):
            if axis_size(self.mesh, a) > 1:
                t = col.gather_dim(t, self.mesh.get_group(a), 0)
        return t

    def reduce_stats(self, stats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Step statistics averaged over the data axes (the JAX step's
        global means)."""
        out = {}
        for k, v in stats.items():
            t = v.detach().float().clone()
            for a in ("fsdp", "dp"):
                if axis_size(self.mesh, a) > 1:
                    col.all_reduce_(t, self.mesh.get_group(a))
            out[k] = t / self.n_data
        return out


def match_placements(t, like):
    """``t`` (a DTensor) redistributed to ``like``'s placements, partial
    sums all-reduced first (then a shard is a local slice)."""
    from torch.distributed.tensor import Replicate

    if any(p.is_partial() for p in t.placements):
        t = t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p
                                           for p in t.placements])
    return t.redistribute(like.device_mesh, like.placements)


def serving_shards(tree, model, mesh):
    """This rank's serving shards of a flax-layout params tree (float
    leaves, or int8 leaves ``{"q8", "q8_scale"}``): every leaf the model
    computes tensor-parallel (``model.tp_local_paths``) cut to the rank's
    slice of the dimension :func:`spec_for` gives ``tp``, every stacked
    expert weight the model serves expert-parallel
    (``model.ep_local_paths``) to the rank's experts over ``ep``, every
    other leaf whole.  An int8 leaf must be quantized whole before it is cut
    (its absmax is per output column over the whole contraction, as the
    JAX package quantizes the global array): a row-parallel cut (out,
    down) keeps the per-column scale whole, a column-parallel one (q/k/v,
    gate/up, lm_head, the embedding's hidden width) cuts it with the
    codes.  An int8 kernel operand whose shard would not be lane-tileable
    raises the JAX package's error.  Without a tp axis the tree comes
    back as it is."""
    from mlcomp_tpu_torch.ops.quant import (
        check_tp_shard,
        folded_2d,
        is_quantized_leaf,
        kernel_consumable,
        tree_map_with_path,
    )
    from mlcomp_tpu_torch.parallel.mesh import axis_rank

    local = {}
    for axis, paths in (("tp", "tp_local_paths"), ("ep", "ep_local_paths")):
        n = axis_size(mesh, axis)
        if n > 1 and hasattr(model, paths):
            local.update({key: (axis, n, axis_rank(mesh, axis))
                          for key in getattr(model, paths)(n)})
    if not local:
        return tree

    def cut(t, d: int, n: int, r: int):
        w = t.shape[d] // n
        idx = [slice(None)] * t.ndim
        idx[d] = slice(r * w, (r + 1) * w)
        return t[tuple(idx)]

    def visit(path, leaf):
        key = "/".join(path)
        if key not in local:
            return leaf
        axis, n, r = local[key]
        quant = is_quantized_leaf(leaf)
        q = leaf["q8"] if quant else leaf
        spec = spec_for(key, tuple(q.shape), {axis: n})
        if axis not in spec:
            return leaf
        d = spec.index(axis)
        if not quant:
            return cut(q, d, n, r)
        s = leaf["q8_scale"]
        out = {"q8": cut(q, d, n, r), "q8_scale": s if s.shape[d] == 1 else cut(s, d, n, r)}
        if path[-1] == "kernel" and kernel_consumable(leaf) and not kernel_consumable(out):
            n_contract, m, n_out = folded_2d(leaf)
            check_tp_shard(m if d < n_contract else n_out, n)
        return out

    return tree_map_with_path(visit, tree)
