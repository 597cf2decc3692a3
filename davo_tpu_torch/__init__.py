"""PyTorch / CUDA port of :mod:`davo_tpu` for one NVIDIA H100.

Mirrors the module paths of ``davo_tpu``.  Plain tensor code is PyTorch;
each Pallas kernel on the ported path is a hand-written CUDA kernel for
``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use and bound
with ``ctypes`` (see :mod:`davo_tpu_torch.ops`).  Entry points run on the
card unless the caller passes ``device="cpu"``.
"""
