r"""Image datasets for conv-energy training (PCD on MNIST-like images).

Build addition — the reference ships only 2D synthetic datasets. ``load_mnist``
prefers real MNIST idx files from disk (``MNIST_PATH`` env var or common cache
locations); in the zero-egress build environment it falls back to sklearn's
bundled 8×8 digits, bilinearly upsampled to 28×28 — real handwritten-digit
image data available offline (the shape/scale contract matches MNIST: float32
``(N, 1, 28, 28)`` in ``[-1, 1]``, labels ``(N,)`` int32).
"""

from __future__ import annotations

import gzip
import os
import struct as _struct
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

__all__ = ["load_mnist"]

_MNIST_CANDIDATES = (
    os.environ.get("MNIST_PATH", ""),
    os.path.expanduser("~/.cache/mnist"),
    "/data/mnist",
    "/tmp/mnist",
)


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = _struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = _struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def _try_local_mnist(split: str):
    prefix = "train" if split == "train" else "t10k"
    for root in _MNIST_CANDIDATES:
        if not root or not os.path.isdir(root):
            continue
        for ext in ("", ".gz"):
            img = os.path.join(root, f"{prefix}-images-idx3-ubyte{ext}")
            lbl = os.path.join(root, f"{prefix}-labels-idx1-ubyte{ext}")
            if os.path.exists(img) and os.path.exists(lbl):
                images = _read_idx(img).astype(np.float32)
                labels = _read_idx(lbl).astype(np.int32)
                return images, labels
    return None


def _digits_fallback(split: str):
    """sklearn's bundled 8×8 digits, upsampled to 28×28 (offline-real images)."""
    from sklearn.datasets import load_digits

    digits = load_digits()
    images = digits.images.astype(np.float32) / 16.0 * 255.0  # (N, 8, 8)
    labels = digits.target.astype(np.int32)
    # deterministic split: last 297 samples are "test"
    if split == "train":
        images, labels = images[:1500], labels[:1500]
    else:
        images, labels = images[1500:], labels[1500:]
    x = jnp.asarray(images)[:, None, :, :]  # (N, 1, 8, 8)
    x = jax.image.resize(x, (x.shape[0], 1, 28, 28), method="bilinear")
    return np.asarray(x), labels


def load_mnist(split: str = "train", flatten: bool = False) -> Tuple[Array, Array]:
    """Return ``(images, labels)``: float32 images in [-1, 1], NCHW ``(N,1,28,28)``.

    Real MNIST when idx files are available locally; sklearn-digits fallback
    otherwise (documented above). ``flatten=True`` yields ``(N, 784)``.
    """
    if split not in ("train", "test"):
        raise ValueError(f"split must be 'train' or 'test', got {split!r}")
    local = _try_local_mnist(split)
    if local is not None:
        images, labels = local
        images = images[:, None, :, :]
    else:
        images, labels = _digits_fallback(split)
    x = jnp.asarray(images, jnp.float32) / 127.5 - 1.0
    if x.ndim == 3:
        x = x[:, None]
    if flatten:
        x = x.reshape(x.shape[0], -1)
    return x, jnp.asarray(labels, jnp.int32)
