"""CIFAR-10/100, ImageNet, and the deterministic synthetic stand-in.

Counterpart of ``dgc_tpu/data/datasets.py``: a dataset is a dict of splits
('train', 'test'); each split has ``__len__`` and ``get_batch(indices) ->
(images f32 NHWC, labels int32)``, all numpy on the host. ``CIFAR`` reads
the standard python pickle batches and falls back to :func:`Synthetic`
(the same images and labels as the reference's, from the same numpy
seeds) when the data root is missing; ``ImageNet`` does the same at
224x224 with ImageNet's normalisation (its folder reader is not ported).
"""

import os
import pickle
from typing import Dict, Sequence, Tuple

import numpy as np

__all__ = ["ArraySplit", "SyntheticSplit", "CIFAR", "ImageNet", "Synthetic",
           "CIFAR_MEAN", "CIFAR_STD", "IMAGENET_MEAN", "IMAGENET_STD"]

CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _normalize(images_u8: np.ndarray, mean: np.ndarray,
               std: np.ndarray) -> np.ndarray:
    return (images_u8.astype(np.float32) / 255.0 - mean) / std


def _crop_flip_normalize(images_u8: np.ndarray, ys: np.ndarray,
                         xs: np.ndarray, flips: np.ndarray, pad: int,
                         mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """Crop at ``(ys, xs)`` of the zero-padded images, mirror where
    ``flips``, and normalise as ``u8 * 1/(255 std) - mean/std`` (the
    reference's training-path arithmetic)."""
    scale = (1.0 / (255.0 * std)).astype(np.float32)
    bias = (-mean / std).astype(np.float32)
    n, h, w, c = images_u8.shape
    padded = np.zeros((n, h + 2 * pad, w + 2 * pad, c), images_u8.dtype)
    padded[:, pad:pad + h, pad:pad + w] = images_u8
    iy = ys[:, None] + np.arange(h)[None, :]
    ix = xs[:, None] + np.arange(w)[None, :]
    out = padded[np.arange(n)[:, None, None], iy[:, :, None],
                 ix[:, None, :]]
    fl = flips.astype(bool)
    out[fl] = out[fl][:, :, ::-1]
    return out.astype(np.float32) * scale + bias


class ArraySplit:
    """In-memory split over uint8 NHWC images; the train split augments
    with a zero-padded random crop and a random horizontal flip."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 mean: np.ndarray, std: np.ndarray, train: bool,
                 pad: int = 4, seed: int = 0):
        self.images = images
        self.labels = labels.astype(np.int32)
        self.mean, self.std = mean, std
        self.train = train
        self.pad = pad
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.images)

    def get_batch(self, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        imgs = self.images[indices]
        if self.train:
            n = len(imgs)
            ys = self._rng.randint(0, 2 * self.pad + 1, size=n)
            xs = self._rng.randint(0, 2 * self.pad + 1, size=n)
            flips = self._rng.randint(0, 2, size=n)
            return (_crop_flip_normalize(imgs, ys, xs, flips, self.pad,
                                         self.mean, self.std),
                    self.labels[indices])
        return _normalize(imgs, self.mean, self.std), self.labels[indices]


class SyntheticSplit:
    """Class-prototype images plus noise: a structured, learnable task,
    deterministic from its seeds. Train and test share the prototypes."""

    def __init__(self, n: int, image_size: int, num_classes: int,
                 mean: np.ndarray, std: np.ndarray, seed: int = 0):
        proto_rng = np.random.RandomState(10_000 + num_classes)
        protos = proto_rng.randn(
            num_classes, image_size, image_size, 3).astype(np.float32)
        rng = np.random.RandomState(seed)
        self.labels = rng.randint(0, num_classes, n).astype(np.int32)
        raw = protos[self.labels] + 1.5 * rng.randn(
            n, image_size, image_size, 3).astype(np.float32)
        k = 4.0 * float(np.sqrt(1.0 + 1.5 ** 2))
        self.images = (np.clip((raw + k) / (2 * k), 0.0, 1.0)
                       * 255).astype(np.uint8)
        self.mean, self.std = mean, std

    def __len__(self) -> int:
        return len(self.images)

    def get_batch(self, indices: np.ndarray):
        return (_normalize(self.images[indices], self.mean, self.std),
                self.labels[indices])


def Synthetic(num_classes: int = 10, image_size: int = 32,
              n_train: int = 2048, n_test: int = 512,
              mean: np.ndarray = CIFAR_MEAN, std: np.ndarray = CIFAR_STD,
              seed: int = 0) -> Dict[str, object]:
    return {
        "train": SyntheticSplit(n_train, image_size, num_classes, mean, std,
                                seed=seed),
        "test": SyntheticSplit(n_test, image_size, num_classes, mean, std,
                               seed=seed + 1),
    }


def CIFAR(root: str, num_classes: int = 10, image_size: int = 32,
          synthetic_size: int = 2048, seed: int = 0) -> Dict[str, object]:
    """CIFAR-10/100 from the python pickle batches under ``root``, or the
    synthetic stand-in when ``root`` holds none."""
    name = "cifar-10-batches-py" if num_classes == 10 else "cifar-100-python"
    base = os.path.join(root, name)
    if not os.path.isdir(base):
        if os.path.isdir(root) and any(
                f.startswith("data_batch") for f in os.listdir(root)):
            base = root
        else:
            return Synthetic(num_classes=num_classes, image_size=image_size,
                             n_train=synthetic_size,
                             n_test=max(synthetic_size // 4, 256),
                             mean=CIFAR_MEAN, std=CIFAR_STD, seed=seed)

    def load(files: Sequence[str]):
        xs, ys = [], []
        for f in files:
            with open(os.path.join(base, f), "rb") as fh:
                d = pickle.load(fh, encoding="bytes")
            xs.append(d[b"data"])
            ys.append(d.get(b"labels", d.get(b"fine_labels")))
        x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        y = np.concatenate([np.asarray(y) for y in ys])
        return np.ascontiguousarray(x), y

    if num_classes == 10:
        train_x, train_y = load([f"data_batch_{i}" for i in range(1, 6)])
        test_x, test_y = load(["test_batch"])
    else:
        train_x, train_y = load(["train"])
        test_x, test_y = load(["test"])
    return {
        "train": ArraySplit(train_x, train_y, CIFAR_MEAN, CIFAR_STD,
                            train=True, seed=seed),
        "test": ArraySplit(test_x, test_y, CIFAR_MEAN, CIFAR_STD,
                           train=False),
    }


def ImageNet(root: str, num_classes: int = 1000, image_size: int = 224,
             synthetic_size: int = 512, seed: int = 0) -> Dict[str, object]:
    """ImageNet from ``root/train`` and ``root/val``, or the synthetic
    stand-in (``synthetic_size`` training images) when ``root`` holds
    neither. Reading the image folders is not ported yet."""
    if not (os.path.isdir(os.path.join(root, "train"))
            and os.path.isdir(os.path.join(root, "val"))):
        return Synthetic(num_classes=num_classes, image_size=image_size,
                         n_train=synthetic_size,
                         n_test=max(synthetic_size // 4, 64),
                         mean=IMAGENET_MEAN, std=IMAGENET_STD, seed=seed)
    raise NotImplementedError(
        f"{root} holds ImageNet image folders, whose reader is not ported "
        "yet (ROADMAP.md); move them away to train on the synthetic split")
