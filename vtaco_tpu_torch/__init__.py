"""vtaco_tpu_torch — the PyTorch/CUDA port of vtaco_tpu for NVIDIA Hopper.

The JAX package ``vtaco_tpu`` stays the reference; this package mirrors its
layout so each module's counterpart is easy to find:

  core/      config loading, model factory, weight carry-over from JAX trees
  ops/       geometry, scatter pooling, interpolation, dense decode, the
             plain decoder trunk and metrics; ops/cuda/ holds the CUDA
             kernels (sources in csrc/) with their ctypes wrappers
  models/    nn.Modules: ResNet-18, UNet3D, LocalPoolPointnet, LocalDecoder
             and the ConvOccupancyNetwork composite
  train/     contact-point selection and depth back-projection
  generate/  Generator3D (dense decode + marching cubes + metrics)

It imports torch, numpy and scipy, never jax and nothing of vtaco_tpu.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
