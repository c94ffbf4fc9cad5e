"""CIFAR-10/100, ImageNet, and the deterministic synthetic stand-in.

Counterpart of ``dgc_tpu/data/datasets.py``: a dataset is a dict of splits
('train', 'test'); each split has ``__len__`` and ``get_batch(indices) ->
(images f32 NHWC, labels int32)``, all numpy on the host. ``CIFAR`` reads
the standard python pickle batches and falls back to :func:`Synthetic`
(the same images and labels as the reference's, from the same numpy
seeds) when the data root is missing; ``ImageNet`` reads class folders
(:class:`ImageFolderSplit`, decoded with PIL by a process pool), or falls
back the same way at 224x224 with ImageNet's normalisation.
"""

import os
import pickle
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from dgc_tpu_torch.data.native import crop_flip_normalize

__all__ = ["ArraySplit", "SyntheticSplit", "ImageFolderSplit", "CIFAR",
           "ImageNet", "Synthetic",
           "CIFAR_MEAN", "CIFAR_STD", "IMAGENET_MEAN", "IMAGENET_STD"]

CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _normalize(images_u8: np.ndarray, mean: np.ndarray,
               std: np.ndarray) -> np.ndarray:
    return (images_u8.astype(np.float32) / 255.0 - mean) / std


class ArraySplit:
    """In-memory split over uint8 NHWC images; the train split augments
    with a zero-padded random crop and a random horizontal flip, through
    the C kernel :func:`~dgc_tpu_torch.data.native.crop_flip_normalize`,
    drawing the offsets and flips in the JAX package's order."""

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
            flips = self._rng.randint(0, 2, size=n).astype(np.uint8)
            return (crop_flip_normalize(imgs, ys, xs, flips, self.pad,
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


def _decode_one(args) -> np.ndarray:
    """Decode and augment one image, a module-level function so that a
    process pool can run it. ``args`` is ``(path, side, train, seed)``;
    the augmentation draws from its own ``RandomState(seed)``, so the
    result is the same inline, in a pool, in any order. Train: a random
    scale (0.08-1 of the area) and aspect (3/4-4/3) crop, at most 10
    tries, else the whole image, resized to ``side``, then a random
    horizontal flip; eval: the shorter side resized to ``side * 256 /
    224``, then the centre ``side`` x ``side``. Returns uint8 HWC."""
    from PIL import Image
    path, s, train, seed = args
    rng = np.random.RandomState(seed)
    img = Image.open(path).convert("RGB")
    if train:
        w, h = img.size
        area = w * h
        for _ in range(10):
            target = rng.uniform(0.08, 1.0) * area
            ar = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if cw <= w and ch <= h:
                x = rng.randint(0, w - cw + 1)
                y = rng.randint(0, h - ch + 1)
                img = img.crop((x, y, x + cw, y + ch)).resize((s, s))
                break
        else:
            img = img.resize((s, s))
        arr = np.asarray(img, np.uint8)
        if rng.randint(2):
            arr = arr[:, ::-1]
        return arr
    w, h = img.size
    short = int(s * 256 / 224)
    if w < h:
        img = img.resize((short, int(h * short / w)))
    else:
        img = img.resize((int(w * short / h), short))
    w, h = img.size
    x, y = (w - s) // 2, (h - s) // 2
    return np.asarray(img.crop((x, y, x + s, y + s)), np.uint8)


class ImageFolderSplit:
    """A class-per-directory ImageNet split (classes in sorted order,
    files sorted within each), decoded by a pool of ``workers`` spawned
    processes (one decodes inline; by default the host's cores, at most
    :attr:`MAX_DEFAULT_WORKERS`). Each batch draws its per-image seeds in
    one draw from the split's ``RandomState(seed)``, so its images do not
    depend on the worker count or on the order the pool finishes them.
    Needs PIL, which it imports on construction."""

    #: the default pool's size at most
    MAX_DEFAULT_WORKERS = 32

    def __init__(self, root: str, image_size: int, train: bool,
                 seed: int = 0, workers: Optional[int] = None):
        from PIL import Image  # noqa: F401 -- fail here without PIL
        self.root = root
        self.image_size = image_size
        self.train = train
        self._rng = np.random.RandomState(seed)
        if workers is None:
            workers = min(os.cpu_count() or 1, self.MAX_DEFAULT_WORKERS)
        self.workers = max(1, int(workers))
        self._pool = None
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = [(os.path.join(root, c, f), self.class_to_idx[c])
                        for c in classes
                        for f in sorted(os.listdir(os.path.join(root, c)))]

    def __len__(self) -> int:
        return len(self.samples)

    def _get_pool(self):
        if self._pool is None and self.workers > 1:
            import multiprocessing as mp
            # spawn: a forked copy of a multithreaded parent can deadlock,
            # and the decode needs nothing of the parent's state
            self._pool = mp.get_context("spawn").Pool(self.workers)
        return self._pool

    def close(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def get_batch(self, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        seeds = self._rng.randint(0, 2 ** 31 - 1, size=len(indices))
        args = [(self.samples[i][0], self.image_size, self.train, int(sd))
                for i, sd in zip(indices, seeds)]
        pool = self._get_pool()
        if pool is not None:
            decoded = pool.map(_decode_one, args,
                               chunksize=max(1, len(args) // self.workers))
        else:
            decoded = [_decode_one(a) for a in args]
        labels = np.asarray([self.samples[i][1] for i in indices], np.int32)
        return (_normalize(np.stack(decoded), IMAGENET_MEAN, IMAGENET_STD),
                labels)


def ImageNet(root: str, num_classes: int = 1000, image_size: int = 224,
             synthetic_size: int = 512, seed: int = 0, *,
             synthetic_fallback: bool = True) -> Dict[str, object]:
    """ImageNet from the class folders of ``root/train`` and ``root/val``
    (:class:`ImageFolderSplit`), or, when ``root`` holds neither and
    ``synthetic_fallback``, the synthetic stand-in (``synthetic_size``
    training images)."""
    train_dir = os.path.join(root, "train")
    val_dir = os.path.join(root, "val")
    if not (os.path.isdir(train_dir) and os.path.isdir(val_dir)):
        if synthetic_fallback:
            return Synthetic(num_classes=num_classes, image_size=image_size,
                             n_train=synthetic_size,
                             n_test=max(synthetic_size // 4, 64),
                             mean=IMAGENET_MEAN, std=IMAGENET_STD, seed=seed)
        raise FileNotFoundError(f"ImageNet train/val not found under {root}")
    return {
        "train": ImageFolderSplit(train_dir, image_size, train=True,
                                  seed=seed),
        "test": ImageFolderSplit(val_dir, image_size, train=False),
    }
