"""Device mesh construction and the batch and sequence placements.

The counterpart of mlcomp_tpu/parallel/mesh.py.  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the process group's
ranks (one rank a card), with the JAX package's named axes in its order:

- ``dp``   data parallel (batch dimension; gradients averaged)
- ``fsdp`` fully-sharded data parallel (parameters sharded over it too)
- ``pp``   pipeline parallel (layer stages)
- ``sp``   sequence/context parallel (ring or Ulysses attention)
- ``ep``   expert parallel (MoE experts)
- ``tp``   tensor parallel (heads, MLP width, vocabulary), innermost

Any subset may be used; axes of size 1 are free.  ``MeshSpec`` and the
placement policies are pure and copied from the JAX package, so the tests
hold them against it.  A placement is a tuple with one entry a dimension,
the axis name (or names) it shards over or None: the entries of the JAX
package's ``PartitionSpec``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

AXES = ("dp", "fsdp", "pp", "sp", "ep", "tp")


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape; -1 on at most one axis means "all remaining"."""

    dp: int = -1
    fsdp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1
    tp: int = 1

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = {a: getattr(self, a) for a in AXES}
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one axis may be -1, got {wild}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}"
                )
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {fixed} devices but {n_devices} available"
            )
        return sizes

    @staticmethod
    def from_config(cfg: Optional[Dict[str, int]]) -> "MeshSpec":
        if not cfg:
            return MeshSpec()
        unknown = set(cfg) - set(AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; valid: {AXES}")
        return MeshSpec(**{a: int(v) for a, v in cfg.items()})


def make_mesh(spec: Optional[MeshSpec] = None, device_type: Optional[str] = None):
    """A DeviceMesh over every rank of the process group, axes in
    :data:`AXES` order (``tp`` innermost, so a tensor-parallel group is
    ranks that are neighbours, ``dp`` outermost).  The process group must
    be initialized (``distributed.init_distributed``); ``device_type``
    defaults to ``cuda`` under NCCL and ``cpu`` otherwise."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized process group: call "
            "parallel.distributed.init_distributed() first"
        )
    spec = spec or MeshSpec()
    sizes = spec.resolve(dist.get_world_size())
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(sizes[a] for a in AXES), mesh_dim_names=AXES)


_CURRENT_MESH: list = []


def set_current_mesh(mesh) -> None:
    """Install the process-wide mesh (the Trainer does this); None to clear."""
    _CURRENT_MESH.clear()
    if mesh is not None:
        _CURRENT_MESH.append(mesh)


def current_mesh():
    """The installed mesh, if any: the models read it for the sequence-,
    tensor- and pipeline-parallel paths."""
    return _CURRENT_MESH[0] if _CURRENT_MESH else None


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a DeviceMesh, or of a plain ``{axis: size}``
    mapping (what the pure placement functions below read)."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return dict(mesh)
    names = mesh.mesh_dim_names or ()
    return {a: int(mesh.size(i)) for i, a in enumerate(names)}


def axis_size(mesh, axis: str) -> int:
    return int(mesh_shape(mesh).get(axis, 1))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without a mesh)."""
    if mesh is None or axis_size(mesh, axis) == 1:
        return 0
    return int(mesh.get_local_rank(axis))


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``."""
    return mesh.get_group(axis)


def batch_sharding(mesh) -> Tuple[int, int]:
    """The batch placement over every data-like axis (dp x fsdp, dp
    major): ``(index, count)``, this rank's shard of the batch dimension
    and the number of shards.  Every rank of one (dp, fsdp) coordinate
    (its pp/sp/ep/tp peers) holds the same rows."""
    if mesh is None:
        return 0, 1
    fsdp = axis_size(mesh, "fsdp")
    count = axis_size(mesh, "dp") * fsdp
    return axis_rank(mesh, "dp") * fsdp + axis_rank(mesh, "fsdp"), count


def batch_rows(mesh, batch: int) -> slice:
    """This rank's rows of a global batch of ``batch`` rows."""
    index, count = batch_sharding(mesh)
    if batch % count:
        raise ValueError(f"global batch {batch} not divisible by dp x fsdp = {count}")
    per = batch // count
    return slice(index * per, (index + 1) * per)


def seq_shard_spec(mesh, batch: int, heads: int, kv_heads: int, axis_name: str = "sp",
                   heads_split_sp: bool = False) -> tuple:
    """Placement of (B, S, H, D) attention operands under sequence
    parallelism.

    One policy shared by the ring and Ulysses wrappers: batch over the data
    axes when divisible, sequence over ``axis_name``, heads over tp when
    both head counts divide tp.  ``heads_split_sp`` additionally requires
    the per-tp head counts to divide the sp axis (Ulysses' all-to-all
    splits the local head axis sp ways; the ring never touches heads).
    """
    shape = mesh_shape(mesh)
    dp = shape.get("dp", 1) * shape.get("fsdp", 1)
    batch_axes = ("dp", "fsdp") if batch % max(dp, 1) == 0 else None
    tp = shape.get("tp", 1)
    head_axis = None
    if tp > 1 and heads % tp == 0 and kv_heads % tp == 0:
        if not heads_split_sp:
            head_axis = "tp"
        else:
            sp = shape.get(axis_name, 1)
            if (heads // tp) % sp == 0 and (kv_heads // tp) % sp == 0:
                head_axis = "tp"
    return (batch_axes, axis_name, head_axis, None)


def replicated(mesh) -> tuple:
    """The placement of a replicated tensor (``PartitionSpec()``)."""
    return ()
