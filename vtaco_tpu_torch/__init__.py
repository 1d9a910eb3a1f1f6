"""vtaco_tpu_torch — the PyTorch/CUDA port of vtaco_tpu for NVIDIA Hopper.

The JAX package ``vtaco_tpu`` stays the reference; this package mirrors its
layout so each module's counterpart is easy to find:

  core/      config loading, model and generator factory, weight carry-over
             from JAX trees, checkpoints
  ops/       geometry, scatter pooling, interpolation, dense decode, the
             plain decoder trunk, winding numbers and metrics; ops/cuda/
             holds the CUDA kernels (sources in csrc/) with their ctypes
             wrappers
  models/    nn.Modules: ResNet-18, the tactile depth U-Net, UNet2D,
             UNet3D, LocalPoolPointnet (grid and planes, MANO head) and its
             crop form, the MANO layer, LocalDecoder (with the contact
             head) and PatchLocalDecoder, and the ConvOccupancyNetwork
             composite with its hand encoder and nested t2d model
  data/      npz fields (the crop fields among them), transforms,
             Shapes3dDataset with its crop volumes, the batch loader and
             the synthetic dataset generator
  train/     contact sampling, the Trainer (every loss path) and the
             training loop
  generate/  Generator3D (dense decode + marching cubes + metrics, hand
             meshes, predicted tactile clouds), the loop's visualization
             (LoopGenerator) and the Inferencer, which reconstructs a split
  cli/       the entry points: python -m vtaco_tpu_torch.cli.train and
             python -m vtaco_tpu_torch.cli.generate
  utils/     mesh IO

It imports torch, numpy and scipy, never jax and nothing of vtaco_tpu.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
