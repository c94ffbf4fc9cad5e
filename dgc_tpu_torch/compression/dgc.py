"""DGCCompressor — per-tensor sampling geometry and the warm-up schedule.

Counterpart of ``dgc_tpu/compression/dgc.py``: the static, host-side half
of the compressor (``sampling_geometry``, ``initialize``,
``warmup_compress_ratio``). The sparsification itself runs over flat
buffers in :mod:`dgc_tpu_torch.compression.flat`. The port carries the
plain f32 wire only, so the reference's int8/fp16/packed-index wire flags
are not options here. Of its opt-in fused paths it carries two:
``fused_select`` (the select-and-pack kernel on the 2-D buckets) and
``megakernel`` (the forward megakernel on the buckets it owns, the spans
between them on the compensate kernel; also ``DGC_MEGAKERNEL=1``). Both
change no result, only the kernels that compute it.
"""

import math
from typing import Dict, NamedTuple, Tuple

from dgc_tpu_torch.compression.flat import FlatDGCEngine
from dgc_tpu_torch.compression.memory import DGCSGDMemory

__all__ = ["DGCCompressor", "TensorAttrs", "sampling_geometry"]


class TensorAttrs(NamedTuple):
    """Static per-tensor sparsification geometry."""
    numel: int
    shape: Tuple[int, ...]
    num_selects: int
    num_samples: int
    top_k_samples: int
    sample_stride: int


def sampling_geometry(numel: int, sample_ratio: float,
                      compress_ratio: float) -> Tuple[int, int]:
    """``(num_samples, sample_stride)``: the stride starts at
    ``ceil(numel / max(pct, cpr) / 32) * 32 + 1`` and backs off by 8 until
    at least ``max(pct_numel, cpr_numel)`` samples fit."""
    if sample_ratio >= 1.0:
        return numel, 1
    pct_numel = int(math.ceil(numel * sample_ratio))
    cpr_numel = int(math.ceil(2 / compress_ratio))
    if numel <= cpr_numel:
        return numel, 1
    sample_stride = int(math.ceil(numel / max(pct_numel, cpr_numel) / 32)) * 32 + 1
    num_samples = numel // sample_stride
    while num_samples < max(pct_numel, cpr_numel) and sample_stride > 8:
        sample_stride -= 8
        num_samples = numel // sample_stride
    return num_samples, sample_stride


class DGCCompressor:
    """Deep Gradient Compression: momentum-corrected sampled top-k with
    bounded threshold adaptation and the epoch-wise warm-up schedule.
    It behaves as the reference's with ``approx_recall`` set (its
    default): the segment path is taken wherever the reference takes it."""

    def __init__(self, compress_ratio: float, memory: DGCSGDMemory = None,
                 sample_ratio: float = 0.01, strided_sample: bool = True,
                 compress_upper_bound: float = 1.3,
                 compress_lower_bound: float = 0.8,
                 max_adaptation_iters: int = 10, resample: bool = True,
                 warmup_epochs: int = -1, fused_select: bool = False,
                 megakernel: bool = False, verbose: bool = False):
        if not strided_sample:
            raise ValueError("the port samples strided lane blocks only "
                             "(strided_sample=True)")
        if not resample:
            raise ValueError("the port adapts thresholds by the resample "
                             "ladder only (resample=True)")
        self.base_compress_ratio = self.compress_ratio = (
            compress_ratio if compress_ratio <= 1.0 else 1.0 / compress_ratio)
        self.memory = DGCSGDMemory() if memory is None else memory
        self.warmup_epochs = warmup_epochs
        # the reference's default coefficient: ratio ** (1 / (epochs + 1))
        self.warmup_coeff = (self.base_compress_ratio
                             ** (1.0 / (warmup_epochs + 1))
                             if warmup_epochs > 0 else 1)
        self.sample_ratio = min(max(sample_ratio, 0.01), 1.0)
        self.strided_sample = strided_sample
        # read only by the non-resample adaptation, which is not ported
        self.compress_upper_bound = compress_upper_bound
        self.compress_lower_bound = compress_lower_bound
        self.max_adaptation_iters = max_adaptation_iters
        self.resample = resample
        #: read by the flat engine: the select-and-pack kernel, and the
        #: forward megakernel (flat.py, the module docstring)
        self.fused_select = fused_select
        self.megakernel = megakernel
        self.verbose = verbose
        self.attributes: Dict[str, TensorAttrs] = {}

    def initialize(self, named_shapes) -> None:
        """Static attributes for every compressed tensor. ``named_shapes``
        yields ``(name, shape)``, ``(name, tensor)`` or ``(name,
        TensorAttrs)`` (the re-initialisation on a ratio change)."""
        for name, param in named_shapes:
            if isinstance(param, TensorAttrs):
                shape = param.shape
            else:
                shape = tuple(getattr(param, "shape", param))
            numel = int(math.prod(shape))
            num_samples, sample_stride = sampling_geometry(
                numel, self.sample_ratio, self.compress_ratio)
            top_k_samples = int(math.ceil(num_samples * self.compress_ratio))
            num_selects = int(math.ceil(numel * self.compress_ratio))
            self.attributes[name] = TensorAttrs(
                numel=numel, shape=shape, num_selects=num_selects,
                num_samples=num_samples, top_k_samples=top_k_samples,
                sample_stride=sample_stride)
            if self.verbose:
                print(f"   {name:<40}: transmit {num_selects} / {numel} "
                      f"(threshold {top_k_samples} / {num_samples} samples "
                      f"at stride {sample_stride})")

    def warmup_compress_ratio(self, epoch: int) -> bool:
        """Epoch hook; True when the ratio changed, and the engine must then
        be rebuilt (its geometry is ratio-derived)."""
        if self.warmup_epochs > 0 and epoch < self.warmup_epochs:
            compress_ratio = max(self.warmup_coeff ** (epoch + 1),
                                 self.base_compress_ratio)
        else:
            compress_ratio = self.base_compress_ratio
        if compress_ratio != self.compress_ratio:
            self.compress_ratio = compress_ratio
            self.initialize(list(self.attributes.items()))
            return True
        return False

    def make_flat_exchange(self, layout):
        """The flat-buffer engine over ``layout``; call again after every
        ratio change."""
        return FlatDGCEngine(self, layout)
