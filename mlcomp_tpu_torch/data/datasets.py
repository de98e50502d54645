"""Dataset registry: in-memory numpy datasets (the port's copy of
mlcomp_tpu/data/datasets.py, with the port's own Registry).

The reference's data layer is torch Datasets consumed by Catalyst loaders.
Here a dataset is a dict of numpy arrays (``x``, ``y``) — the host-side
representation the loader shards onto the device mesh.  Real corpora load
from disk (``npz``/``image_folder``); synthetic generators cover the
no-network environment and benchmarking (deterministic, seeded).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from mlcomp_tpu_torch.utils.registry import Registry

DATASETS: Registry = Registry("datasets")


@DATASETS.register("synthetic_classification")
def synthetic_classification(
    n: int = 1024,
    num_classes: int = 10,
    dim: int = 64,
    seed: int = 0,
    centers_seed: int = 42,
    scale: float = 3.0,
    **_,
) -> Dict[str, np.ndarray]:
    """Gaussian blobs: linearly separable-ish so training visibly learns.

    ``centers_seed`` fixes the class structure independently of ``seed``
    (which draws the samples), so train/valid splits with different seeds
    come from the SAME distribution.
    """
    centers = (
        np.random.RandomState(centers_seed).randn(num_classes, dim).astype(np.float32)
        * scale
    )
    rng = np.random.RandomState(seed)
    y = rng.randint(0, num_classes, size=n)
    x = centers[y] + rng.randn(n, dim).astype(np.float32)
    return {"x": x.astype(np.float32), "y": y.astype(np.int32)}


@DATASETS.register("synth_mnist")
def synth_mnist(n: int = 2048, seed: int = 0, **_) -> Dict[str, np.ndarray]:
    """MNIST-shaped synthetic digits: class-dependent stroke patterns on a
    28×28 canvas.  Stands in for the reference's MNIST DAG (BASELINE.json:7)
    in the zero-egress environment; swap for `npz` with real MNIST on disk.
    """
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 10, size=n)
    x = rng.rand(n, 28, 28).astype(np.float32) * 0.1
    # deterministic class-dependent bright rectangles (learnable signal)
    for i in range(n):
        c = y[i]
        r0, c0 = 2 + (c % 5) * 4, 2 + (c // 5) * 10
        x[i, r0 : r0 + 6, c0 : c0 + 8] += 0.9
    return {"x": np.clip(x, 0, 1)[..., None], "y": y.astype(np.int32)}


@DATASETS.register("synthetic_images")
def synthetic_images(
    n: int = 256,
    height: int = 224,
    width: int = 224,
    channels: int = 3,
    num_classes: int = 1000,
    seed: int = 0,
    **_,
) -> Dict[str, np.ndarray]:
    """ImageNet-shaped random tensors — benchmarking input for ResNet-50."""
    rng = np.random.RandomState(seed)
    return {
        "x": rng.rand(n, height, width, channels).astype(np.float32),
        "y": rng.randint(0, num_classes, size=n).astype(np.int32),
    }


@DATASETS.register("synthetic_segmentation")
def synthetic_segmentation(
    n: int = 64,
    height: int = 128,
    width: int = 128,
    channels: int = 3,
    num_classes: int = 4,
    seed: int = 0,
    **_,
) -> Dict[str, np.ndarray]:
    """Images with colored quadrant masks — U-Net DAG stand-in."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, height, width, channels).astype(np.float32) * 0.2
    y = np.zeros((n, height, width), dtype=np.int32)
    for i in range(n):
        cls = rng.randint(1, num_classes)
        h0, w0 = rng.randint(0, height // 2), rng.randint(0, width // 2)
        h1, w1 = h0 + height // 3, w0 + width // 3
        y[i, h0:h1, w0:w1] = cls
        x[i, h0:h1, w0:w1, :] += 0.7 * cls / num_classes
    return {"x": np.clip(x, 0, 1), "y": y}


@DATASETS.register("synthetic_tokens")
def synthetic_tokens(
    n: int = 512,
    seq_len: int = 128,
    vocab_size: int = 1000,
    num_classes: int = 2,
    seed: int = 0,
    **_,
) -> Dict[str, np.ndarray]:
    """Token sequences with a parity-of-first-tokens label — BERT stand-in."""
    rng = np.random.RandomState(seed)
    x = rng.randint(1, vocab_size, size=(n, seq_len)).astype(np.int32)
    y = (x[:, :8].sum(axis=1) % num_classes).astype(np.int32)
    return {"x": x, "y": y}


@DATASETS.register("image_folder")
def image_folder(
    path: str,
    image: int = 224,
    limit: int = 0,
    normalize: bool = True,
    **_,
) -> Dict[str, np.ndarray]:
    """Class-per-subdirectory image tree -> (x: NHWC float32, y: int32).

    Layout (torchvision ImageFolder convention): ``path/<class>/<img>``;
    classes are sorted subdirectory names.  Images are resized to
    ``image``² and optionally normalized to [0, 1].  ``limit`` (per
    class, 0 = all) bounds memory for smoke runs.  The native gather
    thread pool (native/dataops.cpp) does the per-batch assembly; decode
    happens once here, host-resident thereafter — the TPU-VM pattern for
    datasets that fit host RAM (ImageNet-100-class scale per host).
    """
    from PIL import Image

    root = Path(path)
    classes = sorted(p.name for p in root.iterdir() if p.is_dir())
    if not classes:
        raise ValueError(f"image_folder: no class subdirectories in {path}")
    exts = {".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp"}
    files: list = []
    ys_list: list = []
    for ci, cls in enumerate(classes):
        cf = sorted(
            f for f in (root / cls).iterdir() if f.suffix.lower() in exts
        )
        if limit:
            cf = cf[:limit]
        files.extend(cf)
        ys_list.extend([ci] * len(cf))
    if not files:
        raise ValueError(f"image_folder: no images under {path}")
    # preallocate and decode row-by-row: one full-size buffer, not two
    # (a decoded-image list + np.stack would double peak host RAM)
    x = np.empty((len(files), image, image, 3), dtype=np.float32)
    for i, f in enumerate(files):
        with Image.open(f) as im:
            x[i] = np.asarray(
                im.convert("RGB").resize((image, image), Image.BILINEAR),
                dtype=np.float32,
            )
    if normalize:
        x /= 255.0
    # "_"-prefixed keys are per-dataset metadata, not batchable arrays
    # (DataLoader keeps them aside; reports read class names from here)
    return {
        "x": x,
        "y": np.asarray(ys_list, dtype=np.int32),
        "_class_names": classes,
    }


@DATASETS.register("token_bin")
def token_bin(
    path: str,
    seq_len: int,
    dtype: Optional[str] = None,
    limit: int = 0,
    **_,
) -> Dict[str, np.ndarray]:
    """Memory-mapped flat token stream -> (N, seq_len) LM training rows.

    The LM-pretraining data path (``cli tokenize`` writes the .bin): a
    single contiguous stream of token ids (documents separated by the
    tokenizer's EOS), chunked into non-overlapping ``seq_len`` rows.
    The array stays an ``np.memmap`` — the loader's gather reads touch
    only the pages of the current batch, so corpora far larger than
    host RAM train fine (the torch-DataLoader-worker analog is the OS
    page cache doing the reading).  ``lm_cross_entropy`` shifts inputs
    internally, so rows need no label column.

    ``dtype`` defaults from the ``<path>.json`` sidecar ``cli
    tokenize`` writes (falling back to uint16); ``limit`` (rows,
    0 = all) bounds smoke runs.
    """
    import json

    p = Path(path)
    meta_path = p.with_suffix(p.suffix + ".json")
    meta: Dict[str, Any] = {}
    if meta_path.exists():
        meta = json.loads(meta_path.read_text())
    dt = np.dtype(dtype or meta.get("dtype", "uint16"))
    stream = np.memmap(p, dtype=dt, mode="r")
    n = len(stream) // seq_len
    if n == 0:
        raise ValueError(
            f"token_bin: {path} holds {len(stream)} tokens < seq_len "
            f"{seq_len}"
        )
    if limit:
        n = min(n, limit)
    x = stream[: n * seq_len].reshape(n, seq_len)
    out: Dict[str, Any] = {"x": x}
    if "vocab_size" in meta:
        out["_vocab_size"] = int(meta["vocab_size"])
    return out


@DATASETS.register("npz")
def npz(
    path: str, x_key: str = "x", y_key: Optional[str] = None, **_
) -> Dict[str, np.ndarray]:
    """Load arrays from an .npz file on host disk (the model-storage path).

    With the default ``y_key`` the ``y`` array is optional (a generation
    prompt set has no labels); an EXPLICITLY configured ``y_key`` must
    exist — a typo should fail at load, not as a label-free training run."""
    with np.load(Path(path)) as f:
        out = {"x": f[x_key]}
        if y_key is not None:
            out["y"] = f[y_key]
        elif "y" in f:
            out["y"] = f["y"]
        return out


def create_dataset(cfg: Dict[str, Any]) -> Dict[str, np.ndarray]:
    cfg = dict(cfg)
    name = cfg.pop("name")
    cfg.pop("batch_size", None)  # loader arg, not dataset arg
    cfg.pop("shuffle", None)
    cfg.pop("drop_last", None)
    return DATASETS.get(name)(**cfg)
