"""PyTorch/CUDA port of aadg_tpu (augmentation-policy search for
domain-generalized segmentation), for one NVIDIA H100.

The JAX package ``aadg_tpu`` is the unchanged reference; each module here
has its counterpart there under the same name. Hand-written CUDA kernels
live in ``csrc/`` and are built on first use by ``_build``.
"""
