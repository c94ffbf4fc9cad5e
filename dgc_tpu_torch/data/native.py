"""The host input pipeline: the fused CIFAR augmentation in C, and the
background preparation and staged upload of batches.

Counterpart of ``dgc_tpu/data/native.py``:

* :func:`crop_flip_normalize` — zero-pad, random crop, horizontal flip and
  the u8 -> f32 normalisation in one pass, OpenMP over the images: the C
  source ``csrc/crop_flip_normalize.c``, built with ``gcc -O3 -fopenmp``
  at first use into ``build/native/`` at the root of the checkout, named
  by a hash of the source and the flags, and loaded with :mod:`ctypes`.
  Unlike the JAX module it has no numpy fallback: where the library
  cannot be built, the call raises. :func:`crop_flip_normalize_plain` is
  the numpy version the tests hold it against.
* :class:`Prefetcher` — a background thread that prepares batch k+1 (and
  further, up to ``depth``) while the caller runs step k.
* :func:`stage_ahead` — keeps ``depth`` staged items (e.g. uploads in
  flight) ahead of the consumer.
"""

import ctypes
import hashlib
import os
import queue
import subprocess
import threading
from collections import deque
from pathlib import Path
from typing import Iterator, Tuple

import numpy as np

__all__ = ["crop_flip_normalize", "crop_flip_normalize_plain",
           "Prefetcher", "stage_ahead"]

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "crop_flip_normalize.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ("-O3", "-fopenmp", "-ffp-contract=off", "-shared", "-fPIC")

_lib = None
_lock = threading.Lock()


def _build() -> ctypes.CDLL:
    """Compile the source unless its library exists, and load it. The
    library lands by ``os.replace`` of a per-process temporary, so a
    killed or concurrent build never leaves a truncated one."""
    text = _SRC.read_bytes()
    tag = hashlib.sha1(text + " ".join(_FLAGS).encode()).hexdigest()[:12]
    so = BUILD_DIR / f"crop_flip_normalize-{tag}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
        try:
            subprocess.run(["gcc", *_FLAGS, str(_SRC), "-o", str(tmp)],
                           check=True, capture_output=True, text=True,
                           timeout=120)
        except FileNotFoundError as e:
            raise RuntimeError("gcc not found: the input pipeline's crop "
                               f"kernel is built from {_SRC}") from e
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"building {_SRC} failed:\n{e.stderr}") from e
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.crop_flip_normalize.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
    lib.crop_flip_normalize.restype = None
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build()
        return _lib


def _affine(mean: np.ndarray, std: np.ndarray):
    """``(scale, bias)`` of the normalisation ``u8 * scale + bias``."""
    return ((1.0 / (255.0 * std)).astype(np.float32),
            (-mean / std).astype(np.float32))


def crop_flip_normalize_plain(images_u8: np.ndarray, ys: np.ndarray,
                              xs: np.ndarray, flips: np.ndarray, pad: int,
                              mean: np.ndarray, std: np.ndarray
                              ) -> np.ndarray:
    """The numpy version: crop at ``(ys, xs)`` of the zero-padded images,
    mirror where ``flips``, normalise as ``u8 * 1/(255 std) - mean/std``
    (the reference's training-path arithmetic), NHWC f32."""
    scale, bias = _affine(mean, std)
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


def crop_flip_normalize(images_u8: np.ndarray, ys: np.ndarray,
                        xs: np.ndarray, flips: np.ndarray, pad: int,
                        mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """:func:`crop_flip_normalize_plain` through the C kernel; the offsets
    must lie in ``[0, 2 pad]``."""
    n, h, w, c = images_u8.shape
    if c != 3:
        raise ValueError(f"expected NHWC RGB images, got {images_u8.shape}")
    ys32 = np.ascontiguousarray(ys, np.int32)
    xs32 = np.ascontiguousarray(xs, np.int32)
    fl8 = np.ascontiguousarray(flips, np.uint8)
    if not all(a.shape == (n,) for a in (ys32, xs32, fl8)):
        raise ValueError("one offset pair and one flip an image")
    if n and (min(ys32.min(), xs32.min()) < 0
              or max(ys32.max(), xs32.max()) > 2 * pad):
        raise ValueError(f"crop offsets outside [0, {2 * pad}]")
    images_u8 = np.ascontiguousarray(images_u8, np.uint8)
    scale, bias = _affine(mean, std)
    out = np.empty((n, h, w, 3), np.float32)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    _library().crop_flip_normalize(
        p(images_u8, ctypes.c_uint8), p(out, ctypes.c_float),
        p(ys32, ctypes.c_int32), p(xs32, ctypes.c_int32),
        p(fl8, ctypes.c_uint8), n, h, w, pad,
        p(scale, ctypes.c_float), p(bias, ctypes.c_float))
    return out


def stage_ahead(iterator, stage, depth: int = 1):
    """Yield ``stage(item)`` for each item in order, calling ``stage`` on
    up to ``depth`` items ahead of the one the consumer holds: while the
    consumer works on item k, items k+1..k+depth are already staged (e.g.
    their uploads issued)."""
    pending = deque()
    for item in iterator:
        pending.append(stage(item))
        if len(pending) > depth:
            yield pending.popleft()
    while pending:
        yield pending.popleft()


class Prefetcher:
    """Background-thread batch preparation (the role of a DataLoader
    worker): ``split.get_batch(idx)`` for each index array of
    ``index_iter``, in order, up to ``depth`` batches ahead of the
    consumer. An error in the thread is raised to the consumer at the
    batch where it occurred. Call :meth:`close` when done, also after
    leaving the iteration early."""

    def __init__(self, split, index_iter: Iterator[np.ndarray],
                 depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._fill, args=(split, index_iter), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _fill(self, split, index_iter):
        try:
            for idx in index_iter:
                if self._stop.is_set() or not self._put(
                        ("item", split.get_batch(idx))):
                    return
        except Exception as e:   # handed to the consumer, raised there
            self._put(("error", e))
            return
        self._put(("end", None))

    def close(self, timeout: float = 5.0):
        """Stop the thread and drop its buffered batches."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            kind, payload = self._q.get()
            if kind == "error":
                raise payload
            if kind == "end":
                return
            yield payload
