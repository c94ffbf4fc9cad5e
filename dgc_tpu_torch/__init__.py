"""dgc_tpu_torch — Deep Gradient Compression in PyTorch on NVIDIA Hopper.

The PyTorch/CUDA port of the ``dgc_tpu`` JAX package, which stays the
reference. Module names follow the reference package so a reader finds the
counterpart of each piece; the flat-buffer format (layout, transmit-record
words, wire payload) is identical, so buffers are interchangeable between
the two.

The hot paths run through kernels written by hand for ``sm_90a``
(``dgc_tpu_torch.ops.kernels``): the flat engine's bit-masked momentum
compensate, its form that also emits the segment top-2 candidates, the
standalone candidates and the per-tensor memory's compensate (Triton);
the exact per-row top-k, the select-and-pack, the forward megakernel, the
post-gather apply, the ladder counts and the opaque-view copies (CUDA
C++). Each has a plain PyTorch version beside it, which a wrapper runs
only for tensors that lie on the CPU.

Entry points take a ``device`` argument that defaults to ``"cuda"``; they
raise when no card is present unless the CPU was asked for.
"""

__all__ = []
