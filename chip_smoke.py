"""Smoke run of the PyTorch port (vtaco_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root of a checkout. Phases, each printed as it
ends:
  1. device: the card's name and power limit (nvidia-smi), the torch and
     CUDA versions; TF32 is turned off for matmuls and cuDNN, since the JAX
     reference computes in IEEE float32.
  2. build: nvcc compiles every CUDA source of the package (in parallel).
  host_engines (after the build): the native host engines (g++ at first
     use) on the card's host: marching cubes on a 129^3 field against
     _marching_cubes_numpy (the same triangle soup; both times), on a
     513^3 field on min(cpu_count, 8) x-slabs against one thread (the
     same soup and vertex count: the weld), and the lattice encode of
     the shuffled 128^3 lattice against its numpy form (the same nodes).
  init (after host_engines): get_model on the card for VTacO_YCB,
     VTacOH_YCB and tactile_test at their shipped widths, drawn from a
     CUDA torch.Generator: every floating tensor against its
     initializer's analytic std (tests/port_checks.py: within 5 standard
     errors, lecun tensors within their cut), zeros and ones exact; the
     tensor count, the worst z-score and the seconds.
  helpers (after init): the JAX package's geometry and metric helpers
     that the port added (Camera, transform_points, project_to_camera,
     the quaternion algebra, rotmat_projection, hand_joint_error) on
     card tensors against the same calls on the CPU: 1e-6 absolute
     (rotmat_projection 1e-5), hand_joint_error exact.
  3. kernels: K2 and K1 against their plain PyTorch versions at the
     flagship shapes (N = 128^3 query points, C = hidden = 32, 5 blocks,
     K = 128 contacts per finger), max abs error <= 1e-4: c_img rows, bf16
     storage, odd N, N below one tile, the mesh lattice's order, weights
     and gates made under torch.inference_mode, and for K1 contact sets
     spread with invalid rows, clustered, all invalid and 32 times as many
     per finger. Then each kernel's time (CUDA events, after warm-up,
     cycling three distinct input sets) on uniform random points (the
     yardstick of earlier runs) and on the lattice (dense_query_grid_cn,
     the main path's order; K1 with clustered contacts), beside its bound
     and the plain version's time. The bound is the largest of the 32 x 32
     chain products at the 3xTF32 tensor-core rate (a third of the TF32
     rate, the card's fastest f32-accurate unit), the other operations at
     the f32 CUDA-core rate and the bytes at the memory rate; bound_f32_ms
     puts every operation on the CUDA cores. K1's bound counts the distance
     tests of its culled per-tile contact lists (K.window_gate_candidates).
  4. window kernels: K3 (coords only, c_img rows) and K4 (contact-gated)
     against their plain versions at N = 2^21 points sorted by super-cell
     on the 64^3 x 32 grid, with an odd N, N below one tile, unsorted
     points, an L = 2 plan and an undersized window whose overflow count
     must equal the plain count, and for K4 a contact set placed at
     r (1 +- 1e-6) from the kernel's tile boxes, 32 times the contacts per
     finger, and weights and contacts made under torch.inference_mode; the
     kernel's super-cell keys against the torch keys on the card and on the
     CPU; then timed as in phase 3, K4's bound counting the distance tests
     of its culled per-tile contact lists (K.window_gate_candidates), and
     the wrappers' host time per call at 2^19 points.
  5. main path: VTacO_YCB at full width with random weights from a seed,
     Generator3D.generate_obj_mesh_wnf at nx = 128 on a synthetic batch,
     contact-gated (kernel K1) and ungated (kernel K2), MESH_REPS warm
     meshes each (one warm mesh since MESH_REPS is 1); launch counters are
     zeroed just before these runs and must be positive after them. Then a
     breakdown of a mesh by stage (over MESH_REPS meshes), and the dense
     logits of each mode held against the plain PyTorch trunk on the same
     inputs.
  f7 (before 5): generation.matmul_precision. With PyTorch's own TF32
     flags for the phase (cuDNN's on, cuBLAS's off), VTacO_YCB's encode
     and contact gates at full width (Generator3D._encode_sample) at
     'highest' within 1e-6 relative of the same with both flags off (the
     UNet3D grid, the ResNet-18 features), and at 'default' (TF32) more
     than 1e-5 away, the control that the check sees TF32; the flags
     are put back after.
  6. eval_points: the same model and batch, Generator3D.eval_points at
     float32 transfer on (a) 2^21, (b) 100,000 and (d) 2^19 uniform points
     in [-0.54, 0.54]^3 and (c) the shuffled 128^3 lattice, ungated and
     contact-gated. Counters are zeroed just before; each set must take
     the JAX package's route (ROUTES): (a) and (d) the window route (K3,
     K4 launch; L = 1 and L = 2 plans), (b) and (c) the gather route (K1,
     K2 launch, the window kernels do not). Median of three warm calls per
     set and mode, a stage breakdown of the window route, and the logits
     against the plain route on the same points.
  7. vtacoh: VTacOH_YCB (fingertip gating) at full width, random weights
     from seed 0, the synthetic batch from seed 0 with the ground-truth
     wrist set so that the fingertips land around the object (aim_hand).
     The scan is rescaled so that the random hand's tips span 0.6 of the
     box. (a) generate_obj_mesh_wnf at nx = 128: one cold and MESH_REPS warm meshes
     (K2 launched on the c_img rows of gate_tips_cn, counters zeroed just
     before), a breakdown by stage with tips_gates_s (ResNet-18, the hand
     encoder, the tips in the object frame, gate_tips_cn), K2's logits on
     those rows against trunk_cn, each point's gate against a float64
     gate_tips_cn (points within 1e-6 of r² = 0.0025 or of a tie counted and
     left out), the share gated and the touching fingers, then K2's and
     gate_tips_cn's time on the lattice. (b) eval_points with the fingertip
     gates on sets (a) and (d): the window route (K3 on c_img rows only),
     K3's logits against window_trunk_plain with the same rows, call_s,
     and K3's time in its c_img mode.
  8. batched: (a) K2 over BATCH_B = 4 objects in one launch
     (fused_trunk_cn_batched, K2 under the JAX package's vmap) against its
     plain version (trunk_cn per object) on the shared 128^3 grid and on
     4 objects' own 2^19 nodes of MISE's 512^3 lattice, timed against 4
     single-object K2 launches on the same inputs, beside its bound (4
     times the single-object work, the shared grid read once). Then
     VTacO_YCB at full width on 4 objects (make_batch from seeds 0..3),
     the decoder's feature conditioning damped by MISE_GAIN so that the
     random field crosses its level along a surface of the object's size
     through the contacts (mise_model): (b) decode_dense_batched at
     nx = 128 (one batched K2 launch a call) against eval_points_dense per
     object; (c) generate_obj_mesh_mise at the config's default (128
     coarse, 2 levels: 513^3), contact-gated (K1 once per level), its time
     with the stats split, query_pts per level beside the counts of the
     object's own surface (object_queries, each level must reach
     MISE_SPAN of them, and gated points at each) and the marching cubes'
     time, and each level's values, as the grid keeps them, against
     eval_points_fast on the same points as float world coordinates
     (another encoding and route; points within 1e-6 of r^2 left out); (d) multires_decode_batched at 64 coarse with 2
     levels (257^3; one batched K2 launch per level) against
     multires_decode per object, values within 1e-5 of the level counted
     and left out with what they can reach. Counters are zeroed just
     before (b), (c) and (d) and read just after: only the expected
     kernel may launch, as many times as expected.
  planes (after vtacoh): plane feature fields through K1 and K2. VTacO_YCB
     with its object encoder on three PLANES_RESO^2 planes (the hand
     encoder's U-Net on each; no grid, no UNet3D), random weights from
     seed 0, the batch of phase 5: generate_obj_mesh_wnf at nx = 128
     contact-gated (K1) and ungated (K2), one cold and one warm mesh
     each; eval_points on PLANES_EVAL_N uniform points in both modes (the
     gather route: the window route declines planes), one cold and three
     warm calls; counters zeroed just before each and only K1 and K2 may
     launch; then K1 and K2 on the plane-summed features of the mesh's
     grid and of the points against their plain versions (max abs error
     <= 1e-4; points within 1e-6 of r^2 left out), eval_points' logits
     equal to the kernel's.
  9. pipeline: the paper's three stages through the port's entry points,
     at full width on one synthetic set made from seed 0 (PIPELINE_MODELS
     models: 12 in the train split, 2 val, 2 test; 100,000 query points,
     320x240 tactile images), each model initialized from a seed:
     (a) tactile: configs/tactile/tactile_test.yaml (the depth U-Net and
     the sensor-pose head) at its batch of 12; train.loop.train takes
     TRAIN_LOOP_ITERS steps with validation, a checkpoint and the CLI's
     visualization hook; then the warm step time at each of
     TRAIN_PRECISIONS ('default', the config's training.matmul_precision,
     lets cuBLAS and cuDNN run in TF32 as the CLI does; 'highest' is full
     float32), the steps alternating between them: median, least and most
     of TRAIN_TIMED steps each, CUDA-synchronized, after TRAIN_WARM
     warm-up steps each, with the breakdown by CUDA events at the
     trainer's stage marks; the peak memory; one step at 'highest' held
     against the same step on the CPU from the same weights and batch
     (loss scalars within TRAIN_RTOL relative, each module's gradient
     cosine >= GRAD_COS).
     (b) train: VTacO_YCB with encoder_t2d_kwargs.model_file set to (a)'s
     checkpoint as an absolute path (the "loaded pretrained t2d weights"
     line must appear), the same loop, step times, peak memory and step
     against the CPU (with the same contact draws), plus the kernels'
     device time and busy share over TRAIN_PROFILED steps under
     torch.profiler, one validation's time and a mesh reconstructed in
     contact mode from the checkpoint, for which K1's launch counter,
     zeroed just before, must rise.
     (c) vtacoh: VTacOH_YCB at its batch of 6 (no t2d stack, the img loss
     path with its fingertip sample), the same loop (validation on the
     IoU of points_iou), step times, peak memory, the profiler's view and
     the step against the CPU (float32, with the same fingertip draws).
     (d) generate: python -m vtaco_tpu_torch.cli.generate (its main) on
     VTacO_YCB's test split from (b)'s checkpoint and on VTacOH_YCB's from
     (c)'s at nx = 128, --max-samples 1: the last JSON line (n >= 1, finite means), an
     object and a hand mesh per object, K1 (VTacO) or K2 on fingertip rows
     (VTacOH) launched once per object and nothing else (every counter
     zeroed just before, read just after: these launches join the
     kernel's count), and each object's wall time (mesh + hand mesh) and
     its native marching cubes' time.
     (e) the same CLI on the tactile config from (a)'s checkpoint: one
     cloud of 5 x 320 x 240 points per sample. (h) cli.generate
     --batched 2 on VTacO_YCB's test split, then on its train split (six
     flights), from (b)'s checkpoint: the JSON line, a mesh per object,
     K2 batched once per flight and nothing else, objects per second of
     Inferencer.run_batched, each flight's decode between CUDA events, and
     whether flight k + 1's decode is still running on the card when
     flight k's host work starts (flight k + 1 must be launched first). (f) LoopGenerator.visualize
     called directly on each checkpoint's model (VTacO's and VTacOH's
     validation split cut to one object): its files must exist.
     (g) fast: the three *_fast configs (bfloat16 with a float32 decoder,
     the split on the card, K = 8 steps per block) on the same set, VTacO
     grafted from (a). First torch's and the port's GroupNorm on a
     bfloat16 64^3 grid against the float32 evaluation (the port's within
     one ulp). Per config: (a) train.loop.train for K + 2 steps (blocks
     of K, 1, 1; fused validation and a checkpoint at K + 2), then a
     resume to 2K + 3 (blocks of K and 1), the resident split's MB, every
     parameter, BatchNorm buffer and Adam moment float32; (b) at
     'default', FAST_ROUNDS rounds of one fused block and K plain float32
     steps (host batches, compute_dtype and skip_unused_t2d off): the
     step times with least and most, the peak memory of each, launches
     per step and busy share under torch.profiler, and the host syncs
     inside a block (utils.profiling.host_syncs around the fused call; its
     scalars are read after it); (c) a bfloat16 step against the float32
     'highest' step from the same weights (built from seed 0), batch and
     draws, within tests/bf16_checks.step_bars (twice the JAX package's
     own gap on the CPU), forward hooks seeing the encoders in bfloat16
     and the decoder in float32; the same step from the trained weights,
     logged; and each module that runs in bfloat16, alone at the built
     weights under deterministic algorithms, against the port's bfloat16
     evaluation on the host CPU within the card's module bar, each
     planted fault (the module in float32, BatchNorm in bfloat16) logged
     beside it; (d) a remat step
     against FAST_PLAIN plain steps from the trained weights, as the card
     runs them (logged) and under torch.use_deterministic_algorithms
     (held: no farther than the plain steps' spread), BatchNorm buffers
     equal, the peak memory of each; (e) cli.generate from the VTacO and
     VTacOH checkpoints on one test object each (--max-samples 1): K1,
     and K2 on fingertip rows, once (counters zeroed just before; these
     launches join the kernels' count as fast_cli_generate and
     fast_vtacoh_cli_generate).
     (i) crop, before (g): configs/crop/scene_crop.yaml at its shipped full
     width through python -m vtaco_tpu_torch.cli.train (its main) for
     CROP_ITERS steps, then its warm steps at each precision and one
     'highest' step against the CPU's float32 step (TRAIN_RTOL,
     GRAD_COS), then eval_points on CROP_EVAL_N points of the whole scene
     from the checkpoint (its 88^2 planes; the chunked module decode in
     chunks of generation.batch_size), within 1e-4 of the CPU on
     CROP_CPU_N of them. Counters are zeroed before the CLI and before
     eval_points: the crop path launches no kernel, as in the JAX
     package.
     (j) families, after (i): the other model families of the registry
     (family_config), VTacO_YCB at full width with one family's keys
     changed: fam_r50 (ResNet-50 images), fam_pn2 (PointNet++ and the
     point decoder), fam_vox (32^3 binvox inputs written from each
     object's query points, the voxel encoder on the 64^3 grid), fam_att
     (the attention decoder on 2048-point chunks) each through cli.train's
     loop for FAMILY_ITERS steps (fam_vox validates iou_voxels),
     FAMILY_TIMED warm steps, one 'highest' step against the CPU's
     float32 step (TRAIN_RTOL, GRAD_COS), and cli.generate on one test
     object with its encode, gates, decode, marching cubes and EMD split;
     fam_pn2's CLIs raise F8 (d) (the JAX package's Trainer cannot
     initialize the point decoder), so it trains through the Trainer and
     meshes through the Generator instead: K1 launches once for
     fam_r50 and nothing for fam_pn2 and fam_att (their decoders run no
     kernel, as in the JAX package); fam_vox's cli.generate raises F8 (c)
     (a voxel batch holds no object scan) and its eval_points on the 128^3
     lattice launches K2 once; fam_r34 (ResNet-34) only its step against
     the CPU. Counters are zeroed before each CLI call and eval_points;
     these launches join the kernels' count as fam_*.
     (k) parallel, after (h): the parallel modules (vtaco_tpu_torch/
     parallel) at a world of one: a one-rank NCCL group from a file store
     and make_mesh(data=1), so that every collective of the data-parallel
     paths runs. VTacO_YCB's train step at full width (batch 3,
     'highest') through Trainer(device_mesh=...) against the same step
     without a mesh (loss scalars within PARALLEL_RTOL relative, each
     module's gradient cosine >= PARALLEL_COS), the step's time with and
     without the mesh in turns (the collectives' cost at a world of one);
     VTacO_YCB_fast's fused block of 8 under the mesh (no host sync
     inside, finite scalars); eval_points_dense_sharded at nx = 128
     through K2 within one bfloat16 step of eval_points_dense;
     decode_dense_batched and decode_dense_batched_band at 4 x 128^3,
     multires_decode_batched at 257^3
     and Inferencer.run_batched on the test split under the mesh, equal to
     the calls without one. Counters are zeroed just before the mesh
     decodes and read just after (the path "parallel"). One H100 cannot
     measure scaling over several cards.
  widths (after 8 (a)): the generic kernel (csrc/trunk_any.cu), which
     takes every decoder width the tile chain (hidden = C = 32) does not,
     at (hidden, C, n_blocks) of WIDTH_CASES on random weights: K1 (contact
     gated), K2 (coords; c_img rows of C + WIDTH_CI_EXTRA inputs; bf16
     storage once; over WIDTH_B objects sharing the coords), K3 and K4 on
     points sorted by super-cell of an R_GRID^3 grid, at WIDTHS_N points
     (WIDEST_N at the cases above 10,000 weights a layer, hidden 1,024 and
     C 1,024 among them), each against its plain version (max abs error
     <= 1e-4, points within 1e-6 of r^2 left out of the gated ones) with
     its route asserted by the counters (the generic one launched, the
     tile chain not), then timed beside its two bounds (the operations at
     the 3xTF32 tensor-core rate, as the kernel computes, and bound_f32_ms
     at the f32 CUDA-core rate, or the bytes at the memory rate), the
     plain version's time, whether it beat it (faster) and its tile. Then (after options) the main path at a decoder
     width the tile chain does not take: VTacO_YCB at hidden = C =
     WIDE_MODEL (c_dim, the UNet3D's and ResNet-18's outputs, the decoder),
     random weights from seed 0, the batch of phase 5:
     generate_obj_mesh_wnf at nx = 128 contact-gated (generic K1) and
     ungated (generic K2), eval_points on 2^21 uniform points in both
     modes (the window route: generic K3, K4), and decode_dense_batched on
     WIDTH_B objects (generic K2 batched); counters zeroed just before and
     read just after, where only the generic modes may launch; every
     launch of the path recorded with its inputs and held against its
     plain version on them (the window modes' n_overflow against the
     plan's), then each timed there beside its bound: these are the
     numbers of the trunk_any rows of the kernels line, whose launches
     this path counts, with the widths cases under "by_width".
  jax_ckpt (after widths' main path): tests/golden/vtaco_jax.ckpt, a
     model.ckpt that the JAX package's CheckpointIO wrote after two train
     steps of the narrow VTacO_YCB of tests/golden/vtaco_jax.yaml (decoder
     hidden = C = 32), loaded through the port's CheckpointIO (no JAX and
     no msgpack here) into the model and the Trainer's Adam; eval_points on
     JAX's 2,048 seeded points (the window route, K3) and
     eval_points_dense on its 32^3 lattice (K2) from JAX's seeded input
     cloud, counters zeroed just before, each within 1e-4 of
     the JAX package's logits (tests/golden/vtaco_jax_logits.npz); then
     one train step resumed from the file on a synthetic set made here,
     which must finish with finite losses and Adam's step at 3 (at 2 for
     parameters without a gradient, which torch's Adam does not step).
Then one JSON line describing the kernels (K2's and K3's launches by
mode, and their c_img mode's reading; K2 batched's row with the time of
4 single-object launches beside it), and last the line
{"ok": true, "device": {...}}. Any failed check raises: the script exits
non-zero and prints no such line. It needs CUDA and the rest of the
repository; it never falls back to the CPU.
"""

import contextlib
import copy
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
import yaml

from vtaco_tpu_torch import native
from vtaco_tpu_torch.core.checkpoint import CheckpointIO
from vtaco_tpu_torch.core.config import get_dataset, get_generator, get_model, load_config
from vtaco_tpu_torch.data import synthetic
from vtaco_tpu_torch.data.core import BatchLoader
from vtaco_tpu_torch.data.device_data import DeviceBatchLoader, DeviceDataset
from vtaco_tpu_torch.generate import band as B
from vtaco_tpu_torch.generate.marching_cubes import _marching_cubes_numpy, marching_cubes
from vtaco_tpu_torch.ops import fast_trunk as FT
from vtaco_tpu_torch.ops import geometry as G
from vtaco_tpu_torch.ops import metrics
from vtaco_tpu_torch.ops.geometry import make_3d_grid
from vtaco_tpu_torch.ops.cuda import build
from vtaco_tpu_torch.ops.cuda import decode as K
from vtaco_tpu_torch.train import contact as C
from vtaco_tpu_torch.train import loop
from vtaco_tpu_torch.train.trainer import Trainer
from vtaco_tpu_torch.utils import meshio
from vtaco_tpu_torch.cli import generate as generate_cli
from vtaco_tpu_torch.generate import generator as GEN
from vtaco_tpu_torch.generate.generator import make_loop_generator
from vtaco_tpu_torch.ops.dense_decode import (
    dense_feature_volume_cn,
    dense_query_grid_cn,
    scattered_feature_volume_cn,
    scattered_grid_features_cn,
    supercell_keys,
    window_blocks,
    window_overflow,
)
from vtaco_tpu_torch.models.layers import BatchNorm2d, frozen_batch_stats
from vtaco_tpu_torch.core.precision import matmul_precision
from vtaco_tpu_torch.utils.profiling import host_syncs

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
from bf16_checks import (CARD_BAR, CARD_OUTPUTS_LOGGED, bf16_batchnorm,  # noqa: E402
                         exact_zero, step_bars, trained_bars)
from port_checks import check_fresh_model, spread_matrices  # noqa: E402
from voxel_files import write_voxels  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
ATOL = 1e-4
INIT_CONFIGS = (("VTacO_YCB", "configs/VTacO/VTacO_YCB.yaml"),
                ("VTacOH_YCB", "configs/VTacOH/VTacOH_YCB.yaml"),
                ("tactile_test", "configs/tactile/tactile_test.yaml"))
HELPERS_TOL = 1e-6
ROTMAT_TOL = 1e-5
RADIUS = 0.015           # contact gating radius (generator default)
NEAR = 1e-6              # |d2 - r^2| below which a gate decision may round either way
N_FLAGSHIP = 128 ** 3    # resolution_0 32 -> nx 128
WIDTH, N_BLOCKS, K_CONTACTS = 32, 5, 128
MESH_REPS = 1            # warm meshes per mode: one warm mesh, no median
R_GRID, PADDING = 64, 0.1   # VTacO_YCB's feature grid and box padding
# eval_points query sets: (a) the flagship's 2^21 points, (b) the config's
# generation.batch_size, (d) 2^19 points, (c) the shuffled LATTICE_NX^3
# lattice
N_EVAL = {"a": N_FLAGSHIP, "b": 100_000, "d": 1 << 19}
LATTICE_NX = 128
# the route the JAX package takes for each set with its kernels on: (a)
# plans at L = 1, tile 256; no window plan holds (b)'s tiles (272 points
# overflow even at L = 2, tile 256), so it takes the gather route; (d)
# plans at L = 2, tile 256; (c) is a lattice. tests/test_torch_window.py
# holds the port's plans for (a), (b) and (d) against the JAX package's.
ROUTES = {"a": "window", "b": "gather", "d": "window", "c": "gather"}
DEVICE_STAGES = ("encode_s", "gates_s", "dense_features_s", "trunk_s", "transfer_s")
# train phase: loop.train's steps (validated and checkpointed at the last),
# warm-up and timed steps, and the card-against-CPU bars of one step
TRAIN_LOOP_ITERS, TRAIN_WARM, TRAIN_TIMED, TRAIN_PROFILED = 4, 1, 6, 2
TRAIN_PRECISIONS = ("default", "highest")
TRAIN_RTOL, GRAD_COS = 1e-4, 0.999
# the CPU step the card's is held to: float32 on the t2d path; float64 for
# the tactile depth stack, whose U-Net sees the loader's [0, 1/255] images:
# its first conv's output is mostly its bias, and train-mode BatchNorm
# magnifies the float32 rounding of the CPU's reductions over 4.6 million
# positions per channel (the bias's gradient, exactly zero, among them), so
# that the CPU's float32 step strays from the exact one by about as much as
# the bar allows (measured on the card: the tactile U-Net's gradient cosine
# of the CPU's float32 step to its float64 step, 0.99850).
TRAIN_REFERENCE = {"tactile": torch.float64, "train": torch.float32,
                   "vtacoh": torch.float32}
# pipeline phase: models of its synthetic set (12 train, so that
# tactile_test's batch of 12 fits; 2 val, 2 test), their query points
# (both configs' points_subsample) and tactile images (H, W)
PIPELINE_MODELS, PIPELINE_QUERY, PIPELINE_IMG = 16, 100_000, (320, 240)
# fast phase: the *_fast configs (their steps per block K = 8 is read from
# each config) and FAST_ROUNDS timing rounds of one fused block of K steps
# and K plain steps each. (c) holds a bfloat16 step against the card's
# float32 ('highest') step to tests/bf16_checks.step_bars (twice the JAX
# package's own gap, measured on the CPU), and each module of FAST_MODULES
# alone against the port's bfloat16 evaluation on the host CPU to the
# module bars there; (d) compares a remat step with FAST_PLAIN plain steps
# under torch.use_deterministic_algorithms, for which cuBLAS needs a fixed
# workspace (set before its first use).
FAST_CONFIGS = (("vtaco", "configs/VTacO/VTacO_YCB_fast.yaml"),
                ("vtacoh", "configs/VTacOH/VTacOH_YCB_fast.yaml"),
                ("tactile", "configs/tactile/tactile_test_fast.yaml"))
FAST_ROUNDS, FAST_PLAIN = 2, 4
# the modules that a *_fast config runs in bfloat16 (VTacOH's are VTacO's
# at the same widths) → (the model method that runs it, its batch key)
FAST_MODULES = {"vtaco": ("encoder", "encoder_hand", "encoder_img"), "vtacoh": (),
                "tactile": ("encoder_hand", "encoder_img")}
MODULE_METHODS = {"encoder": ("encode_inputs", "inputs"),
                  "encoder_hand": ("encode_hand_inputs", "inputs"),
                  "encoder_img": ("encode_img_inputs", "imgs")}
# batched phase: objects per flight of the batched kernel, dense decode
# and MISE checks, each object's lattice points in the kernel check, the
# damping of the decoder's feature conditioning for MISE (mise_model), and
# the objects per flight of cli.generate --batched
BATCH_B, BATCH_LATTICE_N, MISE_GAIN, BATCH_CLI = 4, 1 << 19, 0.3, 2
# the parallel phase: timed steps per trainer, the step's bars against the
# step without a mesh, the sharded decode's grid
PARALLEL_STEPS, PARALLEL_RTOL, PARALLEL_COS, PARALLEL_NX = 4, 1e-5, 0.9999, 128
# the semi-axes of make_batch's ellipsoid object; MISE's query counts on
# its exact field (object_queries) are what a mesh of the object's size
# would query, and each level of (c) must reach MISE_SPAN of them
OBJECT_AXES, MISE_SPAN = (0.35, 0.25, 0.3), 0.5
# crop stage: scene_crop's steps through cli.train, the scene points its
# eval_points decodes (in chunks of the config's generation.batch_size)
# and the share of them held against the CPU
CROP_ITERS, CROP_EVAL_N, CROP_CPU_N = 4, 1 << 21, 1 << 18
# planes phase: the triplane VTacO_YCB's plane resolution and the points of
# its eval_points call (the gather route)
PLANES_RESO, PLANES_EVAL_N = 64, 100_000
# families phase: the model families in turn (family_config), cli.train's
# steps per family (validated and checkpointed at the last), the warm
# steps timed after them, the voxel grid's side and the attention
# decoder's chunk (points_subsample and generation.batch_size; also its
# input_size, which neither package reads)
# widths phase: the generic kernel's (hidden, C, n_blocks) cases (the last
# two the widest, hidden 1,024 and C 1,024), its points (the cases above
# 10,000 weights a layer at fewer, for the time of their plain versions),
# objects of K2 batched, c_img inputs beyond C, and the width of the main
# path's VTacO_YCB there
WIDTH_CASES = ((16, 16, 5), (64, 32, 3), (32, 128, 5), (256, 512, 5), (1024, 32, 5),
               (512, 1024, 3))
WIDTHS_N, WIDEST_N, WIDTH_B, WIDTH_CI_EXTRA, WIDE_MODEL = 1 << 21, 1 << 18, 4, 8, 64
GENERIC_MODES = ("K1", "K2", "K2:c_img", "K2_batched", "K3", "K4")   # timed apart
JAX_CKPT = os.path.join("tests", "golden", "vtaco_jax.ckpt")
FAMILIES = ("r50", "r34", "pn2", "vox", "att")
FAMILY_ITERS, FAMILY_TIMED, VOX_RES, FAMILY_ATT_CHUNK = 2, 3, 32, 2048
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

# NVIDIA H100 data sheet, dense rates: float32 on the CUDA cores (an FMA is
# two operations), TF32 on the tensor cores, and HBM bandwidth, by the
# product name the card reports.
PEAKS = {"PCIe": (51e12, 378e12, 2.0e12), "NVL": (60e12, 417e12, 3.9e12),
         "SXM": (67e12, 495e12, 3.35e12)}


# each kernel's launch counter: (wrapper, attribute)
COUNTERS = {"fused_trunk_cn": (K.fused_trunk_cn, "launches"),
            "fused_trunk_cn_batched": (K.fused_trunk_cn_batched, "launches"),
            "fused_trunk_gated_cn": (K.fused_trunk_gated_cn, "launches"),
            "fused_trunk_window_cn": (K.fused_trunk_window_cn, "launches"),
            "fused_trunk_window_cn:gated": (K.fused_trunk_window_cn, "launches_gated"),
            # the generic kernel (csrc/trunk_any.cu) by mode; K2's count
            # includes its c_img launches (launches_generic_cimg)
            "trunk_any:K1": (K.fused_trunk_gated_cn, "launches_generic"),
            "trunk_any:K2": (K.fused_trunk_cn, "launches_generic"),
            "trunk_any:K2_batched": (K.fused_trunk_cn_batched, "launches_generic"),
            "trunk_any:K3": (K.fused_trunk_window_cn, "launches_generic"),
            "trunk_any:K4": (K.fused_trunk_window_cn, "launches_generic_gated")}


def log(phase, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


T_START = [time.perf_counter()]


def clock(after):
    """The script's seconds so far, after the phase ``after``: where a
    run's time went."""
    log("clock", after=after, s=round(time.perf_counter() - T_START[0], 3))


def peaks(name):
    for key in ("PCIe", "NVL"):
        if key in name:
            return key, PEAKS[key]
    return "SXM", PEAKS["SXM"]


def cuda_ms(fn, arg_sets, reps):
    """Mean time of fn over reps calls cycling through arg_sets, by CUDA
    events, after one warm-up call per set."""
    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_decoder(dev, seed):
    """LocalDecoder at the flagship widths with every weight random (the
    module zero-initializes fc_1, which would hide half the chain)."""
    from vtaco_tpu_torch.models.decoder import LocalDecoder

    g = torch.Generator().manual_seed(seed)
    dec = LocalDecoder(c_dim=WIDTH, hidden_size=WIDTH, n_blocks=N_BLOCKS)
    with torch.no_grad():
        for p in dec.parameters():
            fan_in = p.shape[-1] if p.dim() > 1 else WIDTH
            p.copy_(torch.randn(p.shape, generator=g) / fan_in ** 0.5)
    return dec.to(dev)


def randomize(model, seed):
    """Every parameter and normalization statistic of ``model`` from a seed:
    fan-in scaled weights, small biases, norm scales and variances in
    [0.5, 1.5]."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            if name.endswith("num_batches_tracked"):
                continue
            is_norm = any(s in name for s in ("bn", "norm", "downsample.1"))
            if t.dim() > 1:
                r = torch.randn(t.shape, generator=g) / t[0].numel() ** 0.5
            elif name.endswith("running_var") or (is_norm and name.endswith("weight")):
                r = 0.5 + torch.rand(t.shape, generator=g)
            else:
                r = 0.1 * torch.randn(t.shape, generator=g)
            t.copy_(r)


def trunk_work(N, with_gate, tests=0, gated=0, store_bytes=4, c_img=False):
    """[chain products' operations, other operations, bytes] the trunk
    needs on these inputs: two operations per multiply-add of every layer,
    the 32 x 32 products (c_img rows, wc, w0, w1) apart from the input
    projection of the coords and the head; with gating, 8 per distance
    test the data needs and one add of h per gated point. Bytes: coords,
    features (and c_img rows) read once, logits written."""
    h = c = WIDTH
    chain = 2 * N * (N_BLOCKS * (c * h + 2 * h * h) + (c * h if c_img else 0))
    other = 2 * N * (3 * h + h)
    if with_gate:
        other += 8 * tests + h * gated
    rows = 3 + c + (c if c_img else 0)
    return [chain, other, N * rows * store_bytes + 4 * N]


def kernel_row(err, ms, plain_ms, work, peak):
    """A kernel's JSON numbers. bound_ms is the largest of the chain
    products at the 3xTF32 tensor-core rate, the other operations at the
    f32 CUDA-core rate and the bytes at the memory rate; bound_f32_ms puts
    all operations on the CUDA cores."""
    chain, other, nbytes = work
    f32_rate, tf32_rate, bw = peak
    t_ops = max(chain / (tf32_rate / 3), other / f32_rate)
    return dict(err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_ops, nbytes / bw) * 1e3,
                bound_by="operations" if t_ops > nbytes / bw else "bytes",
                bound_f32_ms=max((chain + other) / f32_rate, nbytes / bw) * 1e3)


def host_ms(fn, arg_sets, reps):
    """Host time per call of fn, the time it takes to enqueue its work:
    the mean over reps calls cycling through arg_sets, after one warm-up
    call per set."""
    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e3


def interp_work(N):
    """Operations of the window kernels beyond the trunk, per point: the
    coordinates (per axis: divide, add, compare-select, max, multiply, two
    clamps, floor, subtract) and seven lerps per channel (two multiplies
    and an add each, with 1 - w once per axis)."""
    return N * (3 * 9 + 3 + 7 * 3 * WIDTH)


def gate_stats(p, q, valid, radius, chunk=1 << 16, tile=None):
    """Distance tests the kernel's loop needs, points gated, and the mask
    of points farther than NEAR from the radius for every valid contact.
    Without ``tile``, K1's loop: each finger tests its valid contacts and
    stops at its first hit. With ``tile``, K4's: each point tests its
    tile's candidate contacts (K.window_gate_candidates) from the last,
    stopping at its first hit."""
    n_f, k, _ = q.shape
    upto = valid.long().cumsum(1)        # valid rows up to each row, per finger
    if tile is not None:
        cand = K.window_gate_candidates(p, q, valid, radius, tile)
        cand = cand.reshape(cand.shape[0], n_f * k)
        chunk -= chunk % tile
    tests = gated = 0
    keep = []
    for s in range(0, p.shape[1], chunk):
        d2 = FT.contact_sq_dist(p[:, s:s + chunk], q, valid)
        hit = d2 < radius * radius
        any_f = hit.reshape(n_f, k, -1).any(1)
        if tile is None:
            first = torch.gather(upto, 1, hit.reshape(n_f, k, -1).to(torch.uint8).argmax(1))
            tests += int(torch.where(any_f, first, upto[:, -1:]).sum())
        else:
            rows = torch.arange(s, s + d2.shape[1], device=p.device) // tile
            c = cand[rows].T                                   # (F K, n)
            rank = c.to(torch.int32).cumsum(0, dtype=torch.int32)
            last = (rank * (hit & c)).amax(0)                  # 0: no hit
            tests += int(torch.where(last > 0, rank[-1] - last + 1, rank[-1]).sum())
        gated += int(any_f.any(0).sum())
        keep.append(~torch.any(torch.abs(d2 - radius * radius) < NEAR, 0))
    return tests, gated, torch.cat(keep)


def plain_gated(tp, p, f, q, feat, valid, radius, store=None, chunk=1 << 18):
    """gate_contact_cn + trunk_cn in chunks of N: the (5K, N) distance
    matrix of the whole grid would take gigabytes."""
    outs = []
    for s in range(0, p.shape[1], chunk):
        ps = K._stored(p[:, s:s + chunk], store)
        c_img = FT.gate_contact_cn(ps, q, feat, valid, radius)
        outs.append(FT.trunk_cn(tp, ps, K._stored(f[:, s:s + chunk], store), c_img))
    return torch.cat(outs)


def max_err(got, want, keep=None):
    d = torch.abs(got - want)
    if keep is not None:
        d = d[keep]
    err = float(d.max())
    if not (err <= ATOL and torch.isfinite(got).all()):
        raise AssertionError(f"kernel disagrees with its plain version: {err}")
    return err


def contact_sets(dev, seed):
    """Per-finger contacts: spread over the box with 30% invalid rows, or
    clustered in one patch as real fingertips are, or all invalid."""
    g = torch.Generator().manual_seed(seed)
    spread = torch.rand((5, K_CONTACTS, 3), generator=g) * 0.8 - 0.4
    patch = 0.2 + 0.05 * torch.randn((5, K_CONTACTS, 3), generator=g)
    valid = torch.rand((5, K_CONTACTS), generator=g) > 0.3
    feat = torch.randn((5, WIDTH), generator=g)
    return {"invalid_rows": (spread.to(dev), feat.to(dev), valid.to(dev)),
            "clustered": (patch.to(dev), feat.to(dev), valid.to(dev)),
            "all_invalid": (spread.to(dev), feat.to(dev),
                            torch.zeros_like(valid).to(dev))}


def kernel_phase(dev, peak):
    """K2 and K1 against their plain versions, then timed on uniform random
    points (the yardstick of earlier runs) and on the mesh path's lattice
    order."""
    dec = random_decoder(dev, seed=0)
    tp = FT.extract_trunk_params(dec, with_img=False)
    tpi = FT.extract_trunk_params(dec, with_img=True)
    cs = contact_sets(dev, seed=2)
    with torch.inference_mode():    # as eval_points makes weights and gates
        dec_inf = random_decoder(dev, seed=0)
        tp_inf = FT.extract_trunk_params(dec_inf, with_img=False)
        tpi_inf = FT.extract_trunk_params(dec_inf, with_img=True)
        gate_inf = tuple(t.clone() for t in cs["invalid_rows"])
    N = N_FLAGSHIP
    g = torch.Generator(device=dev).manual_seed(1)
    sets = [((torch.rand((3, N), generator=g, device=dev) * 1.1 - 0.55),
             torch.randn((WIDTH, N), generator=g, device=dev)) for _ in range(3)]
    p, f = sets[0]
    # the main path's own order: the 128^3 lattice, z slowest, so each tile
    # of 128 points is one x-row
    lattice = dense_query_grid_cn(128, 1 + PADDING, device=dev)
    sets_lat = [(lattice, b) for _, b in sets]
    n_odd, n_small = 1_000_003, 77
    rows = {}
    with torch.no_grad():
        # K2: coords only (the main path), c_img rows, bf16 storage, odd N,
        # N below one tile, lattice order, inference tensors
        bf = torch.bfloat16
        ci = torch.randn((WIDTH, N), generator=g, device=dev)
        cases = {"coords": (tp, p, f, None, None), "c_img": (tpi, p, f, ci, None),
                 "bf16": (tp, p, f, None, bf),
                 "odd_N": (tp, p[:, :n_odd], f[:, :n_odd], None, None),
                 "small_N": (tp, p[:, :n_small], f[:, :n_small], None, None),
                 "lattice": (tp, lattice, f, None, None),
                 "inference_mode": (tp_inf, p, f, None, None)}
        errs = {}
        for case, (tp_, pn, fn, cn, store) in cases.items():
            want = FT.trunk_cn(tp_, K._stored(pn, store), K._stored(fn, store),
                               None if cn is None else K._stored(cn, store))
            errs[case] = max_err(K.fused_trunk_cn(tp_, pn, fn, cn, store_dtype=store), want)
        log("kernels", kernel="fused_trunk_cn", N=N, n_odd=n_odd, n_small=n_small,
            **{f"err_{k}": v for k, v in errs.items()})
        ms = cuda_ms(lambda a, b: K.fused_trunk_cn(tp, a, b), sets, 30)
        ms_lat = cuda_ms(lambda a, b: K.fused_trunk_cn(tp, a, b), sets_lat, 30)
        plain_ms = cuda_ms(lambda a, b: FT.trunk_cn(tp, a, b), sets, 6)
        work = trunk_work(N, False)
        rows["fused_trunk_cn"] = r = kernel_row(max(errs.values()), ms, plain_ms, work,
                                                peak)
        r.update(lattice_ms=ms_lat, lattice_bound_ms=r["bound_ms"])
        log("kernels", kernel="fused_trunk_cn", ms=ms, lattice_ms=ms_lat,
            plain_ms=plain_ms, bound_ms=r["bound_ms"], bound_f32_ms=r["bound_f32_ms"],
            chain_gflop=work[0] / 1e9, other_gflop=work[1] / 1e9, mb=work[2] / 1e6)

        # K1: spread contacts with invalid rows, clustered, all invalid,
        # bf16 storage, odd N, N below one tile, the lattice with clustered
        # contacts, 32 times the contacts per finger (every 128th point,
        # 2^14, for the plain version's (5 K, N) distances), inference tensors
        g_many = torch.Generator(device=dev).manual_seed(3)
        q_many = torch.rand((5, 32 * K_CONTACTS, 3), generator=g_many,
                            device=dev) * 0.8 - 0.4
        many = (q_many, cs["clustered"][1],
                torch.rand(q_many.shape[:2], generator=g_many, device=dev) > 0.3)
        lat_gate = contact_sets(dev, seed=4)["clustered"]
        cases = {name: (tpi, p, f, None, c) for name, c in cs.items()}
        cases.update(
            bf16=(tpi, p, f, bf, cs["clustered"]),
            odd_N=(tpi, p[:, :n_odd], f[:, :n_odd], None, cs["invalid_rows"]),
            small_N=(tpi, p[:, :n_small], f[:, :n_small], None, cs["invalid_rows"]),
            lattice=(tpi, lattice, f, None, lat_gate),
            many_contacts=(tpi, p[:, ::128].contiguous(), f[:, ::128].contiguous(),
                           None, many),
            inference_mode=(tpi_inf, p, f, None, gate_inf))
        errs, gated = {}, {}
        for case, (tp_, pn, fn, store, (q, feat, valid)) in cases.items():
            want = plain_gated(tp_, pn, fn, q, feat, valid, RADIUS, store=store)
            got = K.fused_trunk_gated_cn(tp_, pn, fn, q, feat, valid,
                                         radius=RADIUS, store_dtype=store)
            _, gated[case], keep = gate_stats(K._stored(pn, store), q, valid, RADIUS)
            errs[case] = (max_err(got, want, keep), int((~keep).sum()),
                          int((torch.abs(got - want) > ATOL).sum()))
        log("kernels", kernel="fused_trunk_gated_cn", N=N,
            **{f"err_{k}": v[0] for k, v in errs.items()},
            **{f"near_{k}": v[1] for k, v in errs.items()},
            **{f"flipped_{k}": v[2] for k, v in errs.items()},
            **{f"gated_{k}": v for k, v in gated.items()})
        # the near shell |d2 - r^2| < 1e-6 is 2e-6 / (2 r) thick, 1.3 % of a
        # lone contact ball at r = 0.015 and more where balls overlap (1.3-2.2 %
        # measured on these sets); at most 5 % leaves 95 % of the gated
        # points in the comparison
        if any(errs[k][1] * 20 > gated[k] for k in errs if gated[k]):
            raise AssertionError("the near-radius shell holds too many points")
        if min(gated[k] for k in ("clustered", "invalid_rows", "lattice")) * 1000 < N:
            raise AssertionError(f"the contact sets gate too few points: {gated}")

        # timed on the spread contacts (every tile of random points keeps
        # every valid contact) and on the lattice with clustered contacts;
        # the bounds count the distance tests of the culled per-tile lists
        q, feat, valid = cs["invalid_rows"]
        ms = cuda_ms(lambda a, b: K.fused_trunk_gated_cn(
            tpi, a, b, q, feat, valid, radius=RADIUS), sets, 30)
        plain_ms = cuda_ms(lambda a, b: plain_gated(
            tpi, a, b, q, feat, valid, RADIUS), sets, 3)
        tests, gated, _ = gate_stats(p, q, valid, RADIUS, tile=K.WINDOW_TILE)
        unculled, _, _ = gate_stats(p, q, valid, RADIUS)
        work = trunk_work(N, True, tests=tests, gated=gated)
        rows["fused_trunk_gated_cn"] = r = kernel_row(
            max(v[0] for v in errs.values()), ms, plain_ms, work, peak)
        log("kernels", kernel="fused_trunk_gated_cn", order="random", ms=ms,
            plain_ms=plain_ms, bound_ms=r["bound_ms"], bound_f32_ms=r["bound_f32_ms"],
            chain_gflop=work[0] / 1e9, other_gflop=work[1] / 1e9, mb=work[2] / 1e6,
            distance_tests=tests, distance_tests_unculled=unculled, gated_points=gated)
        q, feat, valid = lat_gate
        ms_lat = cuda_ms(lambda a, b: K.fused_trunk_gated_cn(
            tpi, a, b, q, feat, valid, radius=RADIUS), sets_lat, 30)
        tests, gated, _ = gate_stats(lattice, q, valid, RADIUS, tile=K.WINDOW_TILE)
        unculled, _, _ = gate_stats(lattice, q, valid, RADIUS)
        work = trunk_work(N, True, tests=tests, gated=gated)
        r_lat = kernel_row(0.0, ms_lat, plain_ms, work, peak)
        r.update(lattice_ms=ms_lat, lattice_bound_ms=r_lat["bound_ms"])
        log("kernels", kernel="fused_trunk_gated_cn", order="lattice", ms=ms_lat,
            bound_ms=r_lat["bound_ms"], bound_f32_ms=r_lat["bound_f32_ms"],
            other_gflop=work[1] / 1e9, distance_tests=tests,
            distance_tests_unculled=unculled, gated_points=gated)
    return rows


def sorted_points(dev, g, n, L, lo=-0.54, hi=0.54):
    """n points uniform in [lo, hi]^3, sorted by super-cell key at L."""
    p = torch.rand((3, n), generator=g, device=dev) * (hi - lo) + lo
    order = torch.sort(supercell_keys(p, R_GRID, PADDING, L), stable=True)[1]
    return p[:, order].contiguous()


def window_kernel_phase(dev, peak):
    """K3 and K4 against their plain versions, then timed."""
    dec = random_decoder(dev, seed=0)
    tp = FT.extract_trunk_params(dec, with_img=False)
    tpi = FT.extract_trunk_params(dec, with_img=True)
    N = N_FLAGSHIP
    g = torch.Generator(device=dev).manual_seed(5)
    sets = [(torch.randn((R_GRID,) * 3 + (WIDTH,), generator=g, device=dev),
             sorted_points(dev, g, N, 1)) for _ in range(3)]
    grid, p = sets[0]
    kw = dict(reso=R_GRID, padding=PADDING, L=1, S=128, tile=1024)

    def check(tp_, p_, kw_, gate=None, c_img=None):
        """Kernel against plain: (max error outside the near shell, near
        count, gated points, overflow count, flipped count)."""
        n = p_.shape[1]
        keys = torch.empty(n, dtype=torch.int32, device=dev)
        extra = {} if c_img is None else {"c_img_cn": c_img}
        if gate is not None:
            extra = dict(gate_pts=gate[0], gate_feat=gate[1], gate_valid=gate[2])
        got, n_over = K.fused_trunk_window_cn(tp_, grid, p_, keys_out=keys,
                                              **kw_, **extra)
        want_keys = supercell_keys(p_, R_GRID, PADDING, kw_["L"])
        if not (torch.equal(keys, want_keys) and torch.equal(
                want_keys.cpu(), supercell_keys(p_.cpu(), R_GRID, PADDING, kw_["L"]))):
            raise AssertionError("kernel, torch-on-card and torch-on-CPU keys differ")
        want_over = int(window_overflow(want_keys, kw_["tile"], kw_["S"],
                                        window_blocks(R_GRID, kw_["L"], kw_["S"])))
        if int(n_over) != want_over:
            raise AssertionError(f"overflow {int(n_over)} != plain {want_over}")
        feats = scattered_grid_features_cn(grid, p_, PADDING)
        if gate is None:
            want, keep, gated = FT.trunk_cn(tp_, p_, feats, c_img), None, 0
        else:
            want = plain_gated(tp_, p_, feats, *gate, RADIUS)
            _, gated, keep = gate_stats(p_, gate[0], gate[2], RADIUS)
            if int((~keep).sum()) * 20 > max(gated, 1):
                raise AssertionError("the near-radius shell holds too many points")
        return max_err(got, want, keep), (0 if keep is None else int((~keep).sum())), \
            gated, want_over, int((torch.abs(got - want) > ATOL).sum())

    rows = {}
    with torch.no_grad():
        errs = {"coords": check(tp, p, kw)}
        ci = torch.randn((WIDTH, N), generator=g, device=dev)
        errs["c_img"] = check(tpi, p, kw, c_img=ci)
        n_odd, n_small = 1_000_003, 77
        errs["odd_N"] = check(tp, p[:, :n_odd], kw)
        errs["small_N"] = check(tp, p[:, :n_small], kw)
        unsorted = p[:, torch.randperm(N, generator=g, device=dev)].contiguous()
        errs["unsorted"] = check(tp, unsorted, kw)
        p2 = sorted_points(dev, g, N, 2)
        errs["L2"] = check(tp, p2, dict(kw, L=2, tile=256))
        errs["undersized_S"] = check(tp, p, dict(kw, S=8))
        if errs["undersized_S"][3] == 0:
            raise AssertionError("the undersized window counts no overflow")
        lib = K._window_lib()
        gate = contact_sets(dev, 6)["clustered"]
        log("kernels", kernel="fused_trunk_window_cn", dynamic_smem_bytes=dict(
            coords=lib.window_smem_bytes(K._window_operands(tp, 0)[0].numel()),
            gated=lib.window_smem_bytes(K._window_operands(tpi, 2, gate)[0].numel())))
        log("kernels", kernel="fused_trunk_window_cn", N=N, n_odd=n_odd,
            n_small=n_small, **{f"err_{k}": v[0] for k, v in errs.items()},
            **{f"overflow_{k}": v[3] for k, v in errs.items()})
        ms = cuda_ms(lambda a, b: K.fused_trunk_window_cn(tp, a, b, **kw), sets, 30)
        sets_d = [(a, b[:, :N_EVAL["d"]].contiguous()) for a, b in sets]
        wrapper_ms = host_ms(lambda a, b: K.fused_trunk_window_cn(tp, a, b, **kw),
                             sets_d, 30)
        plain_ms = cuda_ms(lambda a, b: FT.trunk_cn(
            tp, b, scattered_grid_features_cn(a, b, PADDING)), sets, 6)
        work = trunk_work(N, False)
        work[1] += interp_work(N)
        work[2] += grid.numel() * 4 - N * WIDTH * 4   # the grid, not features
        rows["fused_trunk_window_cn"] = r = kernel_row(
            max(v[0] for v in errs.values()), ms, plain_ms, work, peak)
        log("kernels", kernel="fused_trunk_window_cn", ms=ms, plain_ms=plain_ms,
            bound_ms=r["bound_ms"], bound_f32_ms=r["bound_f32_ms"],
            chain_gflop=work[0] / 1e9, other_gflop=work[1] / 1e9, mb=work[2] / 1e6,
            wrapper_host_ms_2e19=wrapper_ms)

        cs = contact_sets(dev, seed=6)
        errs = {name: check(tpi, p, kw, gate=c) for name, c in cs.items()}
        errs["odd_N"] = check(tpi, p[:, :n_odd], kw, gate=cs["invalid_rows"])
        errs["small_N"] = check(tpi, p[:, :n_small], kw, gate=cs["clustered"])
        errs["unsorted"] = check(tpi, unsorted, kw, gate=cs["invalid_rows"])
        q_edge = K.window_box_edge_contacts(p, seed=7, K=K_CONTACTS, radius=RADIUS)
        errs["box_edge"] = check(tpi, p, kw, gate=(
            q_edge, cs["clustered"][1], torch.ones(q_edge.shape[:2], dtype=torch.bool,
                                                   device=dev)))
        # 32 times the contacts per finger: shared memory does not grow with
        # them (every 128th point, 2^14, for the plain version's (5 K, N)
        # distances)
        g_many = torch.Generator(device=dev).manual_seed(8)
        q_many = torch.rand((5, 32 * K_CONTACTS, 3), generator=g_many,
                            device=dev) * 0.8 - 0.4
        errs["many_contacts"] = check(tpi, p[:, ::128].contiguous(), kw, gate=(
            q_many, cs["clustered"][1],
            torch.rand(q_many.shape[:2], generator=g_many, device=dev) > 0.3))
        # weights and contacts made as inference tensors, as under
        # eval_points' torch.inference_mode
        with torch.inference_mode():
            tpi_inf = FT.extract_trunk_params(random_decoder(dev, seed=0), with_img=True)
            errs["inference_mode"] = check(tpi_inf, p, kw, gate=tuple(
                t.clone() for t in cs["invalid_rows"]))
        log("kernels", kernel="fused_trunk_window_cn:gated", N=N,
            **{f"err_{k}": v[0] for k, v in errs.items()},
            **{f"near_{k}": v[1] for k, v in errs.items()},
            **{f"flipped_{k}": v[4] for k, v in errs.items()},
            **{f"gated_{k}": v[2] for k, v in errs.items()})
        if min(errs["clustered"][2], errs["invalid_rows"][2]) * 1000 < N:
            raise AssertionError("the contact sets gate too few points")
        q, feat, valid = cs["invalid_rows"]
        gk = dict(kw, gate_pts=q, gate_feat=feat, gate_valid=valid)
        ms = cuda_ms(lambda a, b: K.fused_trunk_window_cn(tpi, a, b, **gk), sets, 30)
        wrapper_ms = host_ms(lambda a, b: K.fused_trunk_window_cn(tpi, a, b, **gk),
                             sets_d, 30)
        plain_ms = cuda_ms(lambda a, b: plain_gated(
            tpi, b, scattered_grid_features_cn(a, b, PADDING), q, feat, valid,
            RADIUS), sets, 3)
        tests, gated, _ = gate_stats(p, q, valid, RADIUS, tile=K.WINDOW_TILE)
        unculled, _, _ = gate_stats(p, q, valid, RADIUS)
        work = trunk_work(N, True, tests=tests, gated=gated)
        work[1] += interp_work(N)
        work[2] += grid.numel() * 4 - N * WIDTH * 4
        rows["fused_trunk_window_cn:gated"] = r = kernel_row(
            max(v[0] for v in errs.values()), ms, plain_ms, work, peak)
        log("kernels", kernel="fused_trunk_window_cn:gated", ms=ms,
            plain_ms=plain_ms, bound_ms=r["bound_ms"], bound_f32_ms=r["bound_f32_ms"],
            chain_gflop=work[0] / 1e9, other_gflop=work[1] / 1e9, mb=work[2] / 1e6,
            distance_tests=tests, distance_tests_unculled=unculled, gated_points=gated,
            wrapper_host_ms_2e19=wrapper_ms)
    return rows


def random_tp(dev, H, C, NB, Ci=None, seed=0):
    """extract_trunk_params' dict at any widths, every weight random and
    fan-in scaled: fc_p, fc_p_img over 3 + Ci inputs (Ci = C by default),
    NB blocks."""
    g = torch.Generator().manual_seed(seed)

    def lin(o, i):
        return ((torch.randn((o, i), generator=g) / i ** 0.5).to(dev),
                (0.1 * torch.randn(o, generator=g)).to(dev))

    return {"fc_p": lin(H, 3), "fc_p_img": lin(H, 3 + (C if Ci is None else Ci)),
            "fc_c": [lin(H, C) for _ in range(NB)],
            "blocks": [lin(H, H) + lin(H, H) for _ in range(NB)],
            "fc_out": lin(1, H)}


def any_work(N, H, C, NB, Ci=0, store_bytes=4, tests=0, gated=0, window=False):
    """[operations, bytes] the trunk needs at these widths on these inputs:
    two operations per multiply-add of every layer (the c_img rows' Ci H
    too), 8 per distance test the data needs and one add of h per gated
    point, and with ``window`` interp_work's coordinates and lerps at C
    channels. Bytes: coords, features (or none with ``window``: the
    caller adds the grid) and c_img rows read once, logits written."""
    ops = 2 * N * (NB * (C * H + 2 * H * H) + 4 * H + Ci * H) + 8 * tests + H * gated
    if window:
        ops += N * (3 * 9 + 3 + 7 * 3 * C)
    rows = 3 + (0 if window else C) + Ci
    return [ops, N * rows * store_bytes + 4 * N]


def any_row(err, ms, plain_ms, work, peak):
    """A generic kernel's JSON numbers: bound_ms the larger of its
    operations at the 3xTF32 tensor-core rate (a third of the TF32 rate, as
    the kernel computes its products) and its bytes at the memory rate;
    bound_f32_ms the same with the operations at the f32 CUDA-core rate
    (the plain trunk's IEEE products)."""
    ops, nbytes = work
    t_ops, t_bytes = ops / (peak[1] / 3), nbytes / peak[2]
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops > t_bytes else "bytes",
                bound_f32_ms=max(ops / peak[0], t_bytes) * 1e3)


def generic_launched(phase, mode, before):
    """Raises unless exactly one launch of generic ``mode`` and none of the
    tile chain happened since the counters read ``before``."""
    now = read_counters()
    diff = {k: now[k] - before[k] for k in now if now[k] != before[k]}
    if diff != {f"trunk_any:{mode}": 1}:
        raise AssertionError(f"{phase}: {mode} launched {diff}")


def widths_phase(dev, peak):
    """Every mode of the generic kernel at each of WIDTH_CASES against its
    plain version, its route asserted and timed. Returns {mode: {case:
    row}}."""
    out = {m: {} for m in GENERIC_MODES}
    for H, C, NB in WIDTH_CASES:
        case = f"{H}x{C}x{NB}"
        N = WIDEST_N if H * C > 10_000 else WIDTHS_N
        reps = 3 if N == WIDEST_N else 10
        Ci = C + WIDTH_CI_EXTRA
        g = torch.Generator(device=dev).manual_seed(20)
        tp = random_tp(dev, H, C, NB)
        tpc = random_tp(dev, H, C, NB, Ci=Ci, seed=1)
        sets = [((torch.rand((3, N), generator=g, device=dev) * 1.1 - 0.55),
                 torch.randn((C, N), generator=g, device=dev)) for _ in range(2)]
        p, f = sets[0]
        ci = torch.randn((Ci, N), generator=g, device=dev)
        q, feat, valid = contact_sets(dev, seed=21)["invalid_rows"]
        feat = torch.randn((5, C), generator=g, device=dev)
        grid = torch.randn((R_GRID,) * 3 + (C,), generator=g, device=dev)
        ps = sorted_points(dev, g, N, 1)
        kw = dict(reso=R_GRID, padding=PADDING, L=1, S=128, tile=1024)
        fb = torch.stack([f.roll(b, dims=1) for b in range(WIDTH_B)])
        calls = {   # mode: (kernel call, plain call, work, keep mask or None)
            "K2": (lambda: K.fused_trunk_cn(tp, p, f), lambda: FT.trunk_cn(tp, p, f),
                   any_work(N, H, C, NB), None),
            "K2:c_img": (lambda: K.fused_trunk_cn(tpc, p, f, ci),
                         lambda: FT.trunk_cn(tpc, p, f, ci),
                         any_work(N, H, C, NB, Ci=Ci), None),
            "K2_batched": (lambda: K.fused_trunk_cn_batched(tp, p, fb),
                           lambda: torch.stack([FT.trunk_cn(tp, p, x) for x in fb]),
                           [WIDTH_B * any_work(N, H, C, NB)[0],
                            WIDTH_B * any_work(N, H, C, NB)[1] - (WIDTH_B - 1) * 12 * N],
                           None),
            "K3": (lambda: K.fused_trunk_window_cn(tp, grid, ps, **kw)[0],
                   lambda: FT.trunk_cn(tp, ps, scattered_grid_features_cn(grid, ps, PADDING)),
                   any_work(N, H, C, NB, window=True), None),
        }
        tp_g = random_tp(dev, H, C, NB, seed=2)
        tests, gated, keep = gate_stats(p, q, valid, RADIUS)
        calls["K1"] = (lambda: K.fused_trunk_gated_cn(tp_g, p, f, q, feat, valid,
                                                      radius=RADIUS),
                       lambda: plain_gated(tp_g, p, f, q, feat, valid, RADIUS),
                       any_work(N, H, C, NB, tests=tests, gated=gated), keep)
        tests_s, gated_s, keep_s = gate_stats(ps, q, valid, RADIUS)
        gk = dict(kw, gate_pts=q, gate_feat=feat, gate_valid=valid, radius=RADIUS)
        calls["K4"] = (lambda: K.fused_trunk_window_cn(tp_g, grid, ps, **gk)[0],
                       lambda: plain_gated(tp_g, ps, scattered_grid_features_cn(
                           grid, ps, PADDING), q, feat, valid, RADIUS),
                       any_work(N, H, C, NB, tests=tests_s, gated=gated_s, window=True),
                       keep_s)
        for work in (calls["K3"][2], calls["K4"][2]):
            work[1] += grid.numel() * 4
        with torch.no_grad():
            for mode, (kern, plain, work, keep_) in calls.items():
                before = read_counters()
                got = kern()
                torch.cuda.synchronize()
                generic_launched("widths", mode, before)
                want = plain()
                if keep_ is not None and int((~keep_).sum()) * 100 > N:
                    raise AssertionError(f"widths {case} {mode}: too many points near r")
                err = max_err(got, want, keep_)
                ms = cuda_ms(kern, [()], reps)
                plain_ms = cuda_ms(plain, [()], 2)
                out[mode][case] = r = any_row(err, ms, plain_ms, work, peak)
                log("widths", case=case, mode=mode, N=N, max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    bound_f32_ms=r["bound_f32_ms"], faster=ms < plain_ms,
                    gflop=work[0] / 1e9, mb=work[1] / 1e6, tile=K.any_tile(H),
                    near=0 if keep_ is None else int((~keep_).sum()))
            if case == "64x32x3":      # bf16 storage once
                before = read_counters()
                got = K.fused_trunk_cn(tp, p, f, store_dtype=torch.bfloat16)
                torch.cuda.synchronize()
                generic_launched("widths", "K2", before)
                err = max_err(got, FT.trunk_cn(tp, K._stored(p, torch.bfloat16),
                                               K._stored(f, torch.bfloat16)))
                ms = cuda_ms(lambda: K.fused_trunk_cn(tp, p, f, store_dtype=torch.bfloat16),
                             [()], reps)
                log("widths", case=case, mode="K2", store="bfloat16", max_abs_err=err,
                    ms=ms)
        del sets, grid, ps, fb, calls
        torch.cuda.empty_cache()
    log("widths", slower_than_plain=[f"{case} {mode}" for mode, rows in out.items()
                                     for case, r in rows.items()
                                     if r["ms"] >= r["plain_ms"]])
    return out


def build_wide_model():
    """VTacO_YCB with every feature width WIDE_MODEL (c_dim, the UNet3D's
    output channels, ResNet-18's per-finger features, the decoder's hidden
    size), random weights from seed 0, the batch of phase 5 and a
    generator per mode."""
    cfg = load_config(os.path.join(REPO, "configs/VTacO/VTacO_YCB.yaml"),
                      os.path.join(REPO, "configs/default.yaml"))
    m = cfg["model"]
    m["c_dim"] = WIDE_MODEL
    m["encoder_kwargs"]["unet3d_kwargs"]["out_channels"] = WIDE_MODEL
    m["encoder_img_kwargs"]["num_classes"] = WIDE_MODEL
    m["decoder_kwargs"]["hidden_size"] = WIDE_MODEL
    model = get_model(cfg)
    randomize(model, seed=0)
    batch = make_batch(np.random.default_rng(0), cfg)
    gens = {"contact": get_generator(model, cfg)}
    cfg_none = json.loads(json.dumps(cfg))
    cfg_none["model"]["with_img"] = False
    gens["none"] = get_generator(model, cfg_none)
    return cfg, model, batch, gens


KERNEL_WRAPPERS = ("fused_trunk_cn", "fused_trunk_cn_batched", "fused_trunk_gated_cn",
                   "fused_trunk_window_cn")


def _cloned(x):
    if torch.is_tensor(x):
        return x.clone()
    return tuple(map(_cloned, x)) if isinstance(x, tuple) else x


@contextlib.contextmanager
def recorded_kernel_calls():
    """The generator's kernel wrappers, each call appended to the list
    yielded as (wrapper name, args, kwargs, result), its tensors copied so
    that later work cannot overwrite them."""
    calls, saved = [], {n: getattr(GEN, n) for n in KERNEL_WRAPPERS}

    def recording(name, fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            calls.append((name, _cloned(a), {k: _cloned(v) for k, v in kw.items()},
                          _cloned(out)))
            return out
        return call

    for n, fn in saved.items():
        setattr(GEN, n, recording(n, fn))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(GEN, n, fn)


def generic_plain(name, a, kw):
    """(mode, plain call, keep mask or None, [operations, bytes], C) of a
    recorded wrapper call: the plain version of the function the wrapper
    computed, on the same inputs (the window modes' n_overflow apart), and
    its feature width."""
    tp = a[0]
    H, NB = tp["fc_out"][0].shape[1], len(tp["blocks"])
    store = kw.get("store_dtype")
    sb = 2 if store == torch.bfloat16 else 4
    if name == "fused_trunk_cn_batched":
        p, fb = a[1:3]
        B, C, N = fb.shape
        ops, nbytes = any_work(N, H, C, NB, store_bytes=sb)
        shared = p.dim() == 2
        return ("K2_batched", lambda: torch.stack([
            FT.trunk_cn(tp, K._stored(p if shared else p[b], store), K._stored(fb[b], store))
            for b in range(B)]), None, [B * ops, B * nbytes - shared * (B - 1) * 3 * N * sb],
            C)
    if name == "fused_trunk_window_cn":
        grid, p = a[1:3]
        C, N = grid.shape[-1], p.shape[1]
        ci, gp = kw.get("c_img_cn"), kw.get("gate_pts")
        radius = kw.get("radius", RADIUS)

        def feats():
            return scattered_grid_features_cn(grid, p, kw["padding"])

        if gp is not None:
            tests, gated, keep = gate_stats(p, gp, kw["gate_valid"], radius)
            work = any_work(N, H, C, NB, tests=tests, gated=gated, window=True)
            work[1] += grid.numel() * 4
            return ("K4", lambda: plain_gated(tp, p, feats(), gp, kw["gate_feat"],
                                              kw["gate_valid"], radius), keep, work, C)
        Ci = 0 if ci is None else ci.shape[0]
        work = any_work(N, H, C, NB, Ci=Ci, window=True)
        work[1] += grid.numel() * 4
        return ("K3" if ci is None else "K3:c_img",
                lambda: FT.trunk_cn(tp, p, feats(), ci), None, work, C)
    p, f = a[1:3]
    C, N = f.shape
    if name == "fused_trunk_gated_cn":
        gp, gf, gv = a[3:6]
        radius = kw.get("radius", RADIUS)
        tests, gated, keep = gate_stats(K._stored(p, store), gp, gv, radius)
        return ("K1", lambda: plain_gated(tp, p, f, gp, gf, gv, radius, store), keep,
                any_work(N, H, C, NB, store_bytes=sb, tests=tests, gated=gated), C)
    ci = a[3] if len(a) > 3 else kw.get("c_img_cn")
    Ci = 0 if ci is None else ci.shape[0]
    return ("K2" if ci is None else "K2:c_img",
            lambda: FT.trunk_cn(tp, K._stored(p, store), K._stored(f, store),
                                None if ci is None else K._stored(ci, store)),
            None, any_work(N, H, C, NB, Ci=Ci, store_bytes=sb), C)


def wide_path_phase(dev, peak):
    """The main path at hidden = C = WIDE_MODEL: meshes (K1, K2),
    eval_points (K3, K4) and decode_dense_batched (K2 batched) through the
    generic kernel only; each of those launches against its plain version
    on the inputs the path gave it, then both timed there. Returns (the
    counters of the path, {mode: row})."""
    cfg, model, batch, gens = build_wide_model()
    get = batch_tensors(batch, dev)
    nx = gens["contact"].resolution0 * 4
    g = torch.Generator().manual_seed(30)
    pts = (torch.rand((1 << 21, 3), generator=g) * 1.08 - 0.54).numpy()
    for gen in gens.values():      # first runs: cuDNN plans
        gen.generate_obj_mesh_wnf(model, batch)
    torch.cuda.synchronize()
    zero_counters()
    t = {}
    with recorded_kernel_calls() as calls:
        for mode, gen in gens.items():
            np.random.seed(0)
            t0 = time.perf_counter()
            (verts, faces), emd, cd = gen.generate_obj_mesh_wnf(model, batch)
            torch.cuda.synchronize()
            t[f"mesh_{mode}_s"] = time.perf_counter() - t0
            check_mesh(f"wide {mode}", verts, faces, emd, cd, nx)
            log("wide", mode=mode, verts=len(verts), faces=len(faces), chamfer=cd, emd=emd)
        with torch.no_grad():
            c = model.encode_inputs(get("inputs"))
            for mode, gen in gens.items():
                gates = gen._build_gates(
                    model, get("inputs.img"), get("inputs.depth"),
                    get("inputs.touch_success") > 0.5, get("inputs.pc_ply"),
                    get("points.cam_pos"), get("points.cam_rot"))
                t0 = time.perf_counter()
                vals = gen.eval_points(model, pts, c, *gates, transfer_dtype=torch.float32)
                t[f"eval_points_{mode}_s"] = time.perf_counter() - t0
                if not np.isfinite(vals).all():
                    raise AssertionError(f"wide eval_points {mode}: non-finite logits")
            cb = {k: torch.cat([v] * 2) for k, v in c.items()}
            t0 = time.perf_counter()
            grids = gens["none"].decode_dense_batched(model, nx, cb)
            t["decode_dense_batched_s"] = time.perf_counter() - t0
        launches = read_counters()
    want = {"trunk_any:K1": 1, "trunk_any:K2": 1, "trunk_any:K3": 1, "trunk_any:K4": 1,
            "trunk_any:K2_batched": 1}
    launched_only("wide", launches, want)
    if not np.array_equal(grids[0], grids[1]):
        raise AssertionError("wide decode_dense_batched: two equal objects differ")
    del model, gens, c, cb
    rows = {}
    with torch.no_grad():
        for name, a, kw, out in calls:
            mode, plain, keep, work, C = generic_plain(name, a, kw)
            got = out[0] if isinstance(out, tuple) else out
            err = max_err(got, plain(), keep)
            if isinstance(out, tuple):       # the window modes' overflow count
                keys = supercell_keys(a[2], kw["reso"], kw["padding"], kw["L"])
                want_over = window_overflow(keys, kw["tile"], kw["S"],
                                            window_blocks(kw["reso"], kw["L"], kw["S"]))
                if int(out[1]) != int(want_over):
                    raise AssertionError(f"wide {mode}: n_overflow {int(out[1])}, the "
                                         f"plan's {int(want_over)}")
            fn = getattr(K, name)
            ms = cuda_ms(lambda: fn(*a, **kw), [()], 3)
            plain_ms = cuda_ms(plain, [()], 2)
            rows[mode] = r = any_row(err, ms, plain_ms, work, peak)
            r["widths"] = "%dx%dx%d" % (a[0]["fc_out"][0].shape[1], C, len(a[0]["blocks"]))
            log("wide", mode=mode, widths=r["widths"], shape=list(a[2].shape),
                max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                bound_f32_ms=r["bound_f32_ms"], faster=ms < plain_ms,
                gflop=work[0] / 1e9, mb=work[1] / 1e6,
                tile=K.any_tile(a[0]["fc_out"][0].shape[1]),
                near=0 if keep is None else int((~keep).sum()))
    if sorted(rows) != sorted(k.split(":", 1)[1] for k in want):
        raise AssertionError(f"wide: compared {sorted(rows)}")
    log("wide", width=WIDE_MODEL, nx=nx, **t,
        **{f"launches_{k}": v for k, v in launches.items() if v})
    del calls
    torch.cuda.empty_cache()
    return launches, rows


def jax_ckpt_phase(dev):
    """A JAX model.ckpt through the port's CheckpointIO on the card: JAX's
    logits within 1e-4 through K2, then one resumed train step."""
    cfg = yaml.safe_load(open(os.path.join(REPO, "tests", "golden", "vtaco_jax.yaml")))
    ref = np.load(os.path.join(REPO, "tests", "golden", "vtaco_jax_logits.npz"))
    root = os.path.join(REPO, "out", "chip_smoke_jax_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    data, mesh_root = synthetic.generate(os.path.join(root, "synth"), n_models=4,
                                         n_query=500, n_surface=1000, img_h=32,
                                         img_w=24, seed=7)
    cfg["data"].update(path=data, mesh_dir=os.path.join(mesh_root, "mesh_obj"),
                       depth_origin=os.path.join(mesh_root, "depth_origin.txt"))
    cfg["training"]["out_dir"] = root
    torch.manual_seed(0)
    model = get_model(cfg)
    trainer = Trainer.from_config(model, cfg, mesh_bank=loop.build_mesh_bank(cfg, dev))
    t0 = time.perf_counter()
    scalars = CheckpointIO(root, model=model, optimizer=trainer.optimizer).load(
        os.path.join(REPO, JAX_CKPT))
    load_s = time.perf_counter() - t0
    if scalars.get("it") != 2:
        raise AssertionError(f"jax_ckpt: scalars {scalars}")
    model.eval()
    gen = get_generator(model, cfg)
    zero_counters()
    with torch.no_grad():
        c = model.encode_inputs(torch.as_tensor(ref["inputs"], device=dev))
        got_p = gen.eval_points(model, ref["points"], c, transfer_dtype=torch.float32)
        got_l = gen.eval_points_dense(model, round(len(ref["logits_lattice"]) ** (1 / 3)),
                                      c, transfer_dtype=torch.float32)
    launches = read_counters()
    # the lattice through K2, the points through the window route (K3)
    launched_only("jax_ckpt", launches, {"fused_trunk_cn": 1, "fused_trunk_window_cn": 1})
    errs = {}
    for name, got, want in (("points", got_p, ref["logits_points"]),
                            ("lattice", got_l, ref["logits_lattice"])):
        errs[name] = float(np.abs(got - want).max())
        if not (errs[name] <= ATOL and got.shape == want.shape):
            raise AssertionError(f"jax_ckpt {name}: {errs[name]} from JAX's logits")
    model.train()
    trainer.step = int(scalars["it"])
    np.random.seed(0)
    batch = next(iter(BatchLoader(get_dataset("train", cfg), 2, shuffle=True,
                                  num_workers=1, seed=0)))
    t0 = time.perf_counter()
    step = trainer.train_step(batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    # torch's Adam steps the parameters that got a gradient; the others (no
    # gradient in either package: optax's moments of them stay zero) keep
    # the file's count
    adam_step = {(p.grad is not None, float(trainer.optimizer.state[p]["step"]))
                 for p in model.parameters()}
    if not (all(np.isfinite(v) for v in step.values()) and (True, 3.0) in adam_step
            and adam_step <= {(True, 3.0), (False, 2.0)}):
        raise AssertionError(f"jax_ckpt: resumed step {step}, Adam steps {adam_step}")
    log("jax_ckpt", file=JAX_CKPT, bytes=os.path.getsize(os.path.join(REPO, JAX_CKPT)),
        load_s=load_s, scalars=json.dumps(scalars).replace(" ", ""),
        err_points=errs["points"], err_lattice=errs["lattice"],
        logit_range=[float(ref["logits_lattice"].min()), float(ref["logits_lattice"].max())],
        resumed_loss=step["loss"], resumed_step_s=step_s,
        **{f"launches_{k}": v for k, v in launches.items() if v})
    shutil.rmtree(root)
    return launches


def make_batch(rng, cfg):
    """A B=1 batch in the JAX loader's layout: an ellipsoid object cloud of
    pointcloud_n points (with the config's noise), five 320x240 tactile
    images, depth maps where each finger presses a blob of pixels below the
    gel's rest depth, touch flags (finger 2 not touching), and camera
    poses on a world-frame scan of the object."""
    H, W = 320, 240
    axes = np.array(OBJECT_AXES)

    def surface(n):
        u = rng.standard_normal((n, 3))
        return u / np.linalg.norm(u, axis=1, keepdims=True) * axes

    n = cfg["data"]["pointcloud_n"]
    obj = surface(n) + cfg["data"]["pointcloud_noise"] * rng.standard_normal((n, 3))
    depth = np.full((1, 5, H, W), 0.0215, np.float32)
    yy, xx = np.mgrid[:H, :W]
    for f in range(5):
        cy, cx = rng.integers(100, 220), rng.integers(80, 160)
        depth[0, f][(yy - cy) ** 2 + (xx - cx) ** 2 < 30 ** 2] = 0.0195
    scan = surface(5000) * 0.12
    return {
        "inputs": obj[None].astype(np.float32),
        "inputs.img": rng.random((1, 5, H, W, 3)).astype(np.float32),
        "inputs.depth": depth.reshape(1, 5, H * W),
        "inputs.touch_success": np.array([[1, 1, 0, 1, 1]], np.float32),
        "inputs.pc_ply": scan[None].astype(np.float32),
        "points.points_obj": surface(2048)[None].astype(np.float32),
        "points.mano": np.zeros((1, 51), np.float32),
        "points.wrist": np.zeros((1, 3), np.float32),
        "points.cam_pos": scan[rng.choice(len(scan), 5)][None].astype(np.float32),
        "points.cam_rot": rng.uniform(-np.pi, np.pi, (1, 5, 3)).astype(np.float32),
    }


def check_mesh(mode, verts, faces, emd, cd, nx):
    ok = (len(faces) > 0 and verts.ndim == 2 and verts.shape[1] == 3
          and np.isfinite(verts).all() and faces.min() >= 0
          and faces.max() < len(verts) and np.abs(verts).max() <= 0.56
          and np.isfinite(emd) and np.isfinite(cd))
    if not ok:
        raise AssertionError(f"{mode}: bad mesh or metrics at nx={nx}")


def build_model():
    """VTacO_YCB at full width with random weights from seed 0, the
    synthetic batch from seed 0, and a generator per mode."""
    cfg = load_config(os.path.join(REPO, "configs/VTacO/VTacO_YCB.yaml"),
                      os.path.join(REPO, "configs/default.yaml"))
    model = get_model(cfg)
    randomize(model, seed=0)
    batch = make_batch(np.random.default_rng(0), cfg)
    gens = {"contact": get_generator(model, cfg)}
    cfg_none = json.loads(json.dumps(cfg))
    cfg_none["model"]["with_img"] = False
    gens["none"] = get_generator(model, cfg_none)
    return cfg, model, batch, gens


def batch_tensors(batch, dev):
    def get(key, dtype=torch.float32):
        return torch.as_tensor(batch[key], dtype=dtype, device=dev)
    return get


def timer():
    """mark(name) records the synchronized time since the last mark."""
    t = {}
    last = [time.perf_counter()]

    def mark(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        t[name] = now - last[0]
        last[0] = time.perf_counter()
    return t, mark


def main_path_phase(dev, cfg, model, batch, gens):
    nx = gens["contact"].resolution0 * 4
    n_params = sum(p.numel() for p in model.parameters())
    log("main", config="configs/VTacO/VTacO_YCB.yaml", nx=nx, params=n_params,
        grid=cfg["model"]["encoder_kwargs"]["grid_resolution"])

    cold = {}
    for mode, gen in gens.items():   # first runs: cuDNN plans, library load
        t0 = time.perf_counter()
        gen.generate_obj_mesh_wnf(model, batch)
        torch.cuda.synchronize()
        cold[mode] = time.perf_counter() - t0

    K.fused_trunk_cn.launches = 0
    K.fused_trunk_gated_cn.launches = 0
    results = {mode: [] for mode in gens}
    for _ in range(MESH_REPS):           # the modes alternate, so both see
        for mode, gen in gens.items():   # the same drift of the host's load
            np.random.seed(0)
            t0 = time.perf_counter()
            (verts, faces), emd, cd = gen.generate_obj_mesh_wnf(model, batch)
            torch.cuda.synchronize()
            results[mode].append((verts, faces, emd, cd, time.perf_counter() - t0))
    launches = {"fused_trunk_gated_cn": K.fused_trunk_gated_cn.launches,
                "fused_trunk_cn": K.fused_trunk_cn.launches}
    for mode, runs in results.items():
        for verts, faces, emd, cd, _ in runs:
            check_mesh(mode, verts, faces, emd, cd, nx)
        verts, faces, emd, cd, _ = runs[-1]
        times = [r[-1] for r in runs]
        log("main", mode=mode, verts=len(verts), faces=len(faces), chamfer=cd,
            emd=emd, mesh_s=float(np.median(times)), mesh_s_each=times,
            first_mesh_s=cold[mode])
    log("main", meshes_per_mode=MESH_REPS,
        **{f"launches_{k}": v for k, v in launches.items()})
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    # a time breakdown of a mesh by stage (host clock around synchronized
    # work, median of MESH_REPS), then the dense logits of each mode against
    # the plain trunk
    get = batch_tensors(batch, dev)

    def stages(gen):
        t, mark = timer()
        c = model.encode_inputs(get("inputs"))
        mark("encode_s")
        gates = gen._build_gates(
            model, get("inputs.img"), get("inputs.depth"),
            get("inputs.touch_success") > 0.5, get("inputs.pc_ply"),
            get("points.cam_pos"), get("points.cam_rot"))
        mark("gates_s")
        box = 1 + gen.padding
        feats = dense_feature_volume_cn(c, nx, box, gen.padding)
        p_cn = dense_query_grid_cn(nx, box, device=dev)
        mark("dense_features_s")
        tp = FT.extract_trunk_params(model.decoder, with_img=gates[0] != "none")
        logits = gen._trunk_fast(tp, p_cn, feats, *gates[1:], gates[0],
                                 torch.float32, False)
        mark("trunk_s")
        host = logits.reshape(nx, nx, nx).permute(2, 1, 0).cpu().numpy()
        mark("transfer_s")
        verts, _ = marching_cubes(host)
        mark("marching_cubes_s")
        verts = (verts - nx / 2) * box / nx   # as the generator scales them
        np.random.seed(0)                       # and subsamples them
        np.random.shuffle(verts)
        sample = np.ascontiguousarray(verts[:2048])
        metrics.chamfer_distance(get("points.points_obj"),
                                 torch.as_tensor(sample, device=dev)[None])
        mark("chamfer_s")
        metrics.earth_mover_distance(batch["points.points_obj"][0], sample)
        mark("emd_s")
        return t, (tp, p_cn, feats, gates, logits)

    with torch.no_grad():
        runs = {mode: [] for mode in gens}
        for _ in range(MESH_REPS):
            for mode, gen in gens.items():
                runs[mode].append(stages(gen))
        for mode, rs in runs.items():
            t = {k: float(np.median([r[0][k] for r in rs])) for k in rs[0][0]}
            device_s = sum(t[k] for k in DEVICE_STAGES)
            tp, p_cn, feats, (gating, gp, gf, gv), logits = rs[-1][1]
            if gating == "contact":
                want = plain_gated(tp, p_cn, feats, gp, gf, gv, RADIUS)
                _, gated, keep = gate_stats(p_cn, gp, gv, RADIUS)
                if gated == 0:
                    raise AssertionError("the batch's contacts gate no query point")
            else:
                want, keep, gated = FT.trunk_cn(tp, p_cn, feats), None, 0
            err = max_err(logits, want, keep)
            log("main", mode=mode, logits_vs_plain=err, gated_points=gated,
                near_radius=0 if keep is None else int((~keep).sum()),
                flipped=int((torch.abs(logits - want) > ATOL).sum()),
                logit_min=float(logits.min()), logit_max=float(logits.max()))
            log("main", mode=mode, breakdown="median", **t, device_stages_s=device_s,
                device_share=device_s / sum(t.values()),
                emd_s_each=[r[0]["emd_s"] for r in rs])
    return launches


def eval_points_phase(dev, model, batch, gens):
    """Generator3D.eval_points on sets (a), (b), (c) in both modes: routes,
    plans, warm times, a stage breakdown of the window route, and the
    logits against the plain route."""
    get = batch_tensors(batch, dev)
    with torch.no_grad():
        c = model.encode_inputs(get("inputs"))
        gates = {mode: gen._build_gates(
            model, get("inputs.img"), get("inputs.depth"),
            get("inputs.touch_success") > 0.5, get("inputs.pc_ply"),
            get("points.cam_pos"), get("points.cam_rot"))
            for mode, gen in gens.items()}
    grid = c["grid"][0]
    reso = grid.shape[0]
    rng = np.random.default_rng(7)
    box = 1 + PADDING
    nx = LATTICE_NX
    lat = box * (-0.5 + np.arange(nx, dtype=np.float32) / (nx - 1))
    gx, gy, gz = np.meshgrid(lat, lat, lat, indexing="ij")
    cube = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], 1).astype(np.float32)
    sets = {k: rng.uniform(-0.54, 0.54, (n, 3)).astype(np.float32)
            for k, n in N_EVAL.items()}
    sets["c"] = cube[rng.permutation(len(cube))]
    names = ("fused_trunk_window_cn", "fused_trunk_window_cn:gated",
             "fused_trunk_cn", "fused_trunk_gated_cn")

    def read():
        return {n: getattr(*COUNTERS[n]) for n in names}

    for f, a in COUNTERS.values():
        setattr(f, a, 0)
    launches = {name: 0 for name in names}
    results = {}
    for name, pts in sets.items():
        for mode, gen in gens.items():
            gating, gp, gf, gv = gates[mode]
            before = read()
            times, outs = [], []
            for _ in range(1 + 3):                 # one cold call, three warm
                t0 = time.perf_counter()
                outs.append(gen.eval_points(model, pts, c, gating, gp, gf, gv,
                                            transfer_dtype=torch.float32))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            delta = {k: v - before[k] for k, v in read().items()}
            for k in launches:
                launches[k] += delta[k]
            window = delta["fused_trunk_window_cn"] + delta["fused_trunk_window_cn:gated"]
            gather = delta["fused_trunk_cn"] + delta["fused_trunk_gated_cn"]
            route = "window" if window and not gather else (
                "gather" if gather and not window else "mixed")
            want_route = ROUTES[name]
            kernel = {("window", "none"): "fused_trunk_window_cn",
                      ("window", "contact"): "fused_trunk_window_cn:gated",
                      ("gather", "none"): "fused_trunk_cn",
                      ("gather", "contact"): "fused_trunk_gated_cn"}[(want_route, mode)]
            if route != want_route or delta[kernel] != 4:
                raise AssertionError(f"set {name} {mode}: route {route}, "
                                     f"launches {delta}")
            plan = None
            if name != "c":
                with torch.no_grad():
                    plan = gen._window_plan(
                        torch.as_tensor(np.ascontiguousarray(pts.T), device=dev),
                        reso)
                plan = plan and plan[:2]
            results[(name, mode)] = outs[-1]
            log("eval_points", set=name, mode=mode, n=len(pts), route=route,
                plan=plan, call_s=float(np.median(times[1:])), call_s_each=times[1:],
                first_call_s=times[0], **{f"launches_{k}": v for k, v in delta.items()})
            if any(not np.array_equal(o, outs[-1]) for o in outs):
                raise AssertionError(f"set {name} {mode}: calls differ")

    with torch.no_grad():
        # the window route stage by stage, median of three
        for name in [k for k, v in ROUTES.items() if v == "window"]:
            for mode, gen in gens.items():
                gating, gp, gf, gv = gates[mode]
                tp = FT.extract_trunk_params(model.decoder, with_img=gating != "none")
                runs = []
                for _ in range(3):
                    t, mark = timer()
                    # the host's query-set detection: complete cube, lattice
                    if gen._try_full_grid(model, sets[name], c, gating, gp, gf, gv,
                                          torch.float32, torch.float32) is not None:
                        raise AssertionError(f"set {name} detected as a cube")
                    if gen._estimate_lattice_reso(sets[name], box) is not None:
                        raise AssertionError(f"set {name} detected as a lattice")
                    mark("detect_s")
                    p = torch.as_tensor(np.ascontiguousarray(sets[name].T), device=dev)
                    mark("upload_s")
                    L, tile, order = gen._window_plan(p, reso)
                    mark("keys_sort_plan_s")
                    ps = p[:, order]
                    mark("permute_s")
                    logits, n_over = gen._decode_scatter_window_impl(
                        tp, ps, grid, gp, gf, gv, gating, gen.window_S, tile, L)
                    mark("kernel_s")
                    n_over = int(n_over)
                    mark("overflow_read_s")
                    out = torch.empty_like(logits)
                    out[order] = logits
                    mark("unsort_s")
                    host = out.cpu().numpy()
                    mark("transfer_s")
                    runs.append(t)
                med = {k: float(np.median([r[k] for r in runs])) for k in runs[0]}
                log("eval_points", set=name, mode=mode, breakdown="median", **med,
                    staged_s=sum(med.values()))
                if n_over != 0 or not np.array_equal(host, results[(name, mode)]):
                    raise AssertionError(f"set {name} {mode}: staged run differs")

        # every set's logits against the plain route on the same points
        for (name, mode), got in results.items():
            gating, gp, gf, gv = gates[mode]
            tp = FT.extract_trunk_params(model.decoder, with_img=gating != "none")
            p = torch.as_tensor(np.ascontiguousarray(sets[name].T), device=dev)
            feats = scattered_grid_features_cn(grid, p, PADDING)
            if gating == "contact":
                want = plain_gated(tp, p, feats, gp, gf, gv, RADIUS)
                _, gated, keep = gate_stats(p, gp, gv, RADIUS)
            else:
                want, keep, gated = FT.trunk_cn(tp, p, feats), None, 0
            err = max_err(torch.as_tensor(got, device=dev), want, keep)
            log("eval_points", set=name, mode=mode, logits_vs_plain=err,
                gated_points=gated,
                near_radius=0 if keep is None else int((~keep).sum()))
    if min(launches[k] for k in names[:2]) < 1:
        raise AssertionError(f"a window kernel never launched: {launches}")
    return launches


def aim_hand(model, batch, dev, target=(0.15, 0.0, 0.0), span=0.6):
    """``batch`` with its object scan (``inputs.pc_ply``) rescaled about its
    centroid so that the model's fingertips span ``span`` of the normalized
    object frame, and its ground-truth wrist position (``points.mano[:3]``)
    set so that their mean lands at ``target``. At random weights the hand
    encoder's pose is arbitrary: with the batch's own scan and a zero wrist
    the tips lie far outside the box, and no query point would be gated."""
    get = batch_tensors(batch, dev)
    with torch.no_grad():
        joints = model.encode_hand_inputs(get("inputs"))["mano_joints"]
        zero = torch.zeros((1, 3), device=dev)
        tips = C.tips_in_object_frame(joints, zero, zero, get("inputs.pc_ply"))[0]
    ply = batch["inputs.pc_ply"][0].astype(np.float64)
    centroid = ply.mean(0)
    scale = 2 * np.sqrt(((ply - centroid) ** 2).sum(1)).max()
    world = tips.double().cpu().numpy() * scale + centroid      # before norm_pc_1
    spread = max(np.linalg.norm(a - b) for a in world for b in world)
    new_scale = spread / span
    out = dict(batch, **{"points.mano": batch["points.mano"].copy()})
    out["inputs.pc_ply"] = ((ply - centroid) * (new_scale / scale)
                            + centroid)[None].astype(np.float32)
    out["points.mano"][0, :3] = (np.asarray(target) * new_scale
                                 - (world.mean(0) - centroid)).astype(np.float32)
    return out


def tip_shell(p, tips):
    """(N,) True for points farther than NEAR from r² = TIP_RADIUS² for
    every tip and from a tie of the two nearest tips (squared distances
    in float64): there the float32 gates cannot round either way."""
    r2 = C.TIP_RADIUS ** 2
    d2 = ((p.double().T[:, None] - tips.double()[None]) ** 2).sum(-1)   # (N, 5)
    two = torch.sort(d2, dim=1).values[:, :2]
    return ~(torch.any(torch.abs(d2 - r2) < NEAR, dim=1) | (two[:, 1] - two[:, 0] < NEAR))


def row_fingers(rows, feat):
    """The finger whose feature each (C, N) row holds, -1 for zeros."""
    hit = torch.all(rows.T[:, None, :] == feat[None], dim=-1)     # (N, 5)
    return torch.where(hit.any(1), hit.to(torch.uint8).argmax(1), -1)


def build_vtacoh():
    """VTacOH_YCB at full width with random weights from seed 0, the
    synthetic batch from seed 0 with the hand aimed at the object, and its
    generator (fingertip gating)."""
    cfg = load_config(os.path.join(REPO, "configs/VTacOH/VTacOH_YCB.yaml"),
                      os.path.join(REPO, "configs/default.yaml"))
    model = get_model(cfg)
    randomize(model, seed=0)
    batch = aim_hand(model, make_batch(np.random.default_rng(0), cfg), torch.device("cuda"))
    return cfg, model, batch, get_generator(model, cfg)


def vtacoh_mesh_phase(dev, peak, cfg, model, batch, gen):
    """(a) VTacOH meshes: one cold and MESH_REPS warm generate_obj_mesh_wnf
    (K2 with the fingertip rows, counters zeroed just before), a breakdown
    by stage with tips_gates_s (ResNet-18, the hand encoder, the tips in the
    object frame and gate_tips_cn), K2's logits on those rows against
    trunk_cn, the gate decisions against a float64 gate_tips_cn, and K2's
    time in its c_img mode beside gate_tips_cn's. Returns (launches, the
    K2 c_img row)."""
    nx = gen.resolution0 * 4
    log("vtacoh", config="configs/VTacOH/VTacOH_YCB.yaml", nx=nx,
        params=sum(p.numel() for p in model.parameters()),
        wrist=batch["points.mano"][0, :3].tolist())
    t0 = time.perf_counter()
    gen.generate_obj_mesh_wnf(model, batch)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    for f, a in COUNTERS.values():
        setattr(f, a, 0)
    K.fused_trunk_cn.launches_cimg = K.fused_trunk_window_cn.launches_cimg = 0
    runs = []
    for _ in range(MESH_REPS):
        np.random.seed(0)
        t0 = time.perf_counter()
        (verts, faces), emd, cd = gen.generate_obj_mesh_wnf(model, batch)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
        check_mesh("vtacoh", verts, faces, emd, cd, nx)
    launches = read_counters()
    log("vtacoh", verts=len(verts), faces=len(faces), chamfer=cd, emd=emd,
        mesh_s=float(np.median(runs)), mesh_s_each=runs, first_mesh_s=cold,
        **{f"launches_{k}": v for k, v in launches.items()})
    if launches["fused_trunk_cn:c_img"] != MESH_REPS or sum(launches.values()) != MESH_REPS:
        raise AssertionError(f"vtacoh: the meshes did not run K2 on c_img rows: {launches}")

    get = batch_tensors(batch, dev)
    box = 1 + gen.padding

    def stages():
        t, mark = timer()
        c = model.encode_inputs(get("inputs"))
        mark("encode_s")
        p_cn = dense_query_grid_cn(nx, box, device=dev)
        gating, tips, feat, valid = gen._build_gates(
            model, get("inputs.img"), get("inputs.depth"),
            get("inputs.touch_success") > 0.5, get("inputs.pc_ply"),
            get("points.cam_pos"), get("points.cam_rot"), inputs=get("inputs"),
            mano_gt=get("points.mano"), wrist=get("points.wrist"))
        rows = FT.gate_tips_cn(p_cn, tips, feat, valid)
        mark("tips_gates_s")
        feats = dense_feature_volume_cn(c, nx, box, gen.padding)
        mark("dense_features_s")
        tp = FT.extract_trunk_params(model.decoder, with_img=True)
        logits = K.fused_trunk_cn(tp, p_cn, feats, rows)
        mark("trunk_s")
        host = logits.reshape(nx, nx, nx).permute(2, 1, 0).cpu().numpy()
        mark("transfer_s")
        verts, _ = marching_cubes(host)
        mark("marching_cubes_s")
        verts = (verts - nx / 2) * box / nx
        np.random.seed(0)
        np.random.shuffle(verts)
        sample = np.ascontiguousarray(verts[:2048])
        metrics.chamfer_distance(get("points.points_obj"),
                                 torch.as_tensor(sample, device=dev)[None])
        mark("chamfer_s")
        metrics.earth_mover_distance(batch["points.points_obj"][0], sample)
        mark("emd_s")
        if gating != "tips":
            raise AssertionError(f"vtacoh: gating {gating}")
        return t, (tp, p_cn, feats, tips, feat, valid, rows, logits)

    with torch.no_grad():
        rs = [stages() for _ in range(MESH_REPS)]
        t = {k: float(np.median([r[0][k] for r in rs])) for k in rs[0][0]}
        dev_stages = ("encode_s", "tips_gates_s", "dense_features_s", "trunk_s", "transfer_s")
        device_s = sum(t[k] for k in dev_stages)
        log("vtacoh", breakdown="median", **t, device_stages_s=device_s,
            device_share=device_s / sum(t.values()))
        tp, p_cn, feats, tips, feat, valid, rows, logits = rs[-1][1]
        want = FT.trunk_cn(tp, p_cn, feats, rows)
        err = max_err(logits, want)
        exact = row_fingers(FT.gate_tips_cn(p_cn.double(), tips.double(), feat.double(),
                                            valid), feat.double())
        keep = tip_shell(p_cn, tips)
        got = row_fingers(rows, feat)
        flips = int((got != exact)[keep].sum())
        n = p_cn.shape[1]
        gated = int((got >= 0).sum())
        log("vtacoh", k2_cimg_vs_plain=err, gated_points=gated, gated_share=gated / n,
            touching_fingers=valid.nonzero().flatten().tolist(),
            tips=[[round(float(x), 4) for x in q] for q in tips],
            near_shell=int((~keep).sum()), decisions_vs_float64_flipped=flips)
        if flips or gated == 0 or int((~keep).sum()) * 20 > max(gated, 1):
            raise AssertionError(f"vtacoh: fingertip gates: {gated} gated, {flips} "
                                 f"flipped, {int((~keep).sum())} near the radius")

        # K2 in its c_img mode on these rows, gate_tips_cn, and the plain trunk
        g = torch.Generator(device=dev).manual_seed(11)
        sets = [(p_cn, feats, rows)] + [
            (p_cn, torch.randn(feats.shape, generator=g, device=dev), rows)
            for _ in range(2)]
        ms = cuda_ms(lambda a, b, c: K.fused_trunk_cn(tp, a, b, c), sets, 30)
        plain_ms = cuda_ms(lambda a, b, c: FT.trunk_cn(tp, a, b, c), sets, 6)
        gate_ms = cuda_ms(lambda a, b, c: FT.gate_tips_cn(a, tips, feat, valid), sets, 30)
        row = kernel_row(err, ms, plain_ms, trunk_work(n, False, c_img=True), peak)
        row["gate_tips_ms"] = gate_ms
        log("kernels", kernel="fused_trunk_cn", mode="c_img", order="lattice", N=n,
            ms=ms, plain_ms=plain_ms, bound_ms=row["bound_ms"], gate_tips_cn_ms=gate_ms)
    return launches, row


def read_counters():
    """Every launch counter, K2's and K3's c_img launches apart from their
    others."""
    out = {k: getattr(fn, attr) for k, (fn, attr) in COUNTERS.items()}
    for k, fn in (("fused_trunk_cn", K.fused_trunk_cn),
                  ("fused_trunk_window_cn", K.fused_trunk_window_cn)):
        out[f"{k}:c_img"] = fn.launches_cimg
        out[k] -= fn.launches_cimg
    out["trunk_any:K2:c_img"] = K.fused_trunk_cn.launches_generic_cimg
    out["trunk_any:K2"] -= K.fused_trunk_cn.launches_generic_cimg
    out["trunk_any:K3:c_img"] = K.fused_trunk_window_cn.launches_generic_cimg
    out["trunk_any:K3"] -= K.fused_trunk_window_cn.launches_generic_cimg
    return out


def vtacoh_query_phase(dev, peak, model, batch, gen):
    """(b) eval_points with fingertip gates on sets (a) and (d): the window
    route (K3 with c_img rows), as the JAX plan routes them; K3's logits
    against window_trunk_plain with the same rows; call_s per set; K3's
    time in its c_img mode. Returns (launches, the K3 c_img row)."""
    get = batch_tensors(batch, dev)
    with torch.no_grad():
        c = model.encode_inputs(get("inputs"))
        gating, tips, feat, valid = gen._build_gates(
            model, get("inputs.img"), get("inputs.depth"),
            get("inputs.touch_success") > 0.5, get("inputs.pc_ply"),
            get("points.cam_pos"), get("points.cam_rot"), inputs=get("inputs"),
            mano_gt=get("points.mano"), wrist=get("points.wrist"))
    grid = c["grid"][0]
    rng = np.random.default_rng(7)        # eval_points_phase's sets
    sets = {k: rng.uniform(-0.54, 0.54, (n, 3)).astype(np.float32)
            for k, n in N_EVAL.items()}
    tp = FT.extract_trunk_params(model.decoder, with_img=True)
    total = {}
    row = None
    for name in ("a", "d"):
        pts = sets[name]
        for f, a in COUNTERS.values():
            setattr(f, a, 0)
        K.fused_trunk_cn.launches_cimg = K.fused_trunk_window_cn.launches_cimg = 0
        times, outs = [], []
        for _ in range(1 + 3):
            t0 = time.perf_counter()
            outs.append(gen.eval_points(model, pts, c, gating, tips, feat, valid,
                                        transfer_dtype=torch.float32))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = read_counters()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        route = "window" if launches["fused_trunk_window_cn:c_img"] == 4 and sum(
            launches.values()) == 4 else "other"
        with torch.no_grad():
            p = torch.as_tensor(np.ascontiguousarray(pts.T), device=dev)
            L, tile, order = gen._window_plan(p, grid.shape[0])
            rows = FT.gate_tips_cn(p, tips, feat, valid)
            want, _ = K.window_trunk_plain(tp, grid, p, c_img_cn=rows, reso=grid.shape[0],
                                           padding=gen.padding, L=L, S=gen.window_S,
                                           tile=tile)
            keep = tip_shell(p, tips)
            err = max_err(torch.as_tensor(outs[-1], device=dev), want, keep)
        gated = int((rows.abs().sum(0) > 0).sum())
        log("vtacoh", set=name, n=len(pts), route=route, plan=(L, tile),
            call_s=float(np.median(times[1:])), call_s_each=times[1:],
            first_call_s=times[0], k3_cimg_vs_plain=err, gated_points=gated,
            near_shell=int((~keep).sum()), **{f"launches_{k}": v for k, v in launches.items()})
        if route != "window" or any(not np.array_equal(o, outs[-1]) for o in outs):
            raise AssertionError(f"vtacoh set {name}: route {route}, launches {launches}")
        if gated == 0:
            raise AssertionError(f"vtacoh set {name}: no point gated")
        if name == "a":   # K3 in its c_img mode on the sorted points and their rows
            with torch.no_grad():
                kw = dict(reso=grid.shape[0], padding=gen.padding, L=L, S=gen.window_S,
                          tile=tile)
                ps = p[:, order].contiguous()
                rs = FT.gate_tips_cn(ps, tips, feat, valid)
                g = torch.Generator(device=dev).manual_seed(12)
                arg_sets = [(grid, ps, rs)] + [
                    (torch.randn(grid.shape, generator=g, device=dev), ps, rs)
                    for _ in range(2)]
                ms = cuda_ms(lambda a, b, r: K.fused_trunk_window_cn(
                    tp, a, b, c_img_cn=r, **kw), arg_sets, 30)
                plain_ms = cuda_ms(lambda a, b, r: K.window_trunk_plain(
                    tp, a, b, c_img_cn=r, **kw), arg_sets, 6)
                gate_ms = cuda_ms(lambda a, b, r: FT.gate_tips_cn(b, tips, feat, valid),
                                  arg_sets, 30)
            n = ps.shape[1]
            work = trunk_work(n, False, c_img=True)
            work[1] += interp_work(n)
            work[2] += grid.numel() * 4 - n * WIDTH * 4
            row = kernel_row(err, ms, plain_ms, work, peak)
            row["gate_tips_ms"] = gate_ms
            log("kernels", kernel="fused_trunk_window_cn", mode="c_img", N=n, ms=ms,
                plain_ms=plain_ms, bound_ms=row["bound_ms"], gate_tips_cn_ms=gate_ms)
    return total, row


# ---------------------------------------------------------------------------
# batched serving and MISE

def build_planes():
    """VTacO_YCB with its object encoder on three PLANES_RESO² planes (the
    hand encoder's U-Net on each, no grid, no UNet3D), random weights from
    seed 0, the synthetic batch from seed 0, a generator per mode."""
    cfg = load_config(os.path.join(REPO, "configs/VTacO/VTacO_YCB.yaml"),
                      os.path.join(REPO, "configs/default.yaml"))
    m = cfg["model"]
    m["encoder_kwargs"].update(
        plane_type=["xz", "xy", "yz"], plane_resolution=PLANES_RESO, unet=True,
        unet_kwargs=copy.deepcopy(m["encoder_hand_kwargs"]["unet_kwargs"]), unet3d=False)
    model = get_model(cfg)
    randomize(model, seed=0)
    batch = make_batch(np.random.default_rng(0), cfg)
    gens = {"contact": get_generator(model, cfg)}
    cfg_none = json.loads(json.dumps(cfg))
    cfg_none["model"]["with_img"] = False
    gens["none"] = get_generator(model, cfg_none)
    return cfg, model, batch, gens


def planes_phase(dev, cfg, model, batch, gens):
    """(planes) plane feature fields through K1 and K2: the triplane model's
    meshes at nx = 128, contact-gated (K1) and ungated (K2), one cold and
    one warm each; eval_points on PLANES_EVAL_N uniform points in both
    modes (the gather route: the window route declines planes), one cold
    and three warm calls; each kernel's logits on the plane-summed
    features against its plain version. Counters are zeroed just before
    the meshes and before eval_points. Returns the launches of both paths."""
    get = batch_tensors(batch, dev)
    nx = gens["contact"].resolution0 * 4
    enc = cfg["model"]["encoder_kwargs"]
    log("planes", planes=enc["plane_type"], plane_resolution=enc["plane_resolution"],
        unet_kwargs=enc["unet_kwargs"], nx=nx,
        params=sum(p.numel() for p in model.parameters()))
    zero_counters()
    for mode, gen in gens.items():
        times = []
        for _ in range(2):
            np.random.seed(0)
            t0 = time.perf_counter()
            (verts, faces), emd, cd = gen.generate_obj_mesh_wnf(model, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        check_mesh(f"planes {mode}", verts, faces, emd, cd, nx)
        log("planes", mode=mode, verts=len(verts), faces=len(faces), chamfer=cd, emd=emd,
            mesh_s=times[1], first_mesh_s=times[0])
    mesh_launches = read_counters()
    launched_only("planes_mesh", mesh_launches,
                  {"fused_trunk_gated_cn": 2, "fused_trunk_cn": 2})

    pts = np.random.default_rng(9).uniform(-0.54, 0.54, (PLANES_EVAL_N, 3)).astype(np.float32)
    with torch.no_grad():
        c = model.encode_inputs(get("inputs"))
        gates = {mode: gen._build_gates(
            model, get("inputs.img"), get("inputs.depth"),
            get("inputs.touch_success") > 0.5, get("inputs.pc_ply"),
            get("points.cam_pos"), get("points.cam_rot"))
            for mode, gen in gens.items()}
    zero_counters()
    outs = {}
    for mode, gen in gens.items():
        times = []
        for _ in range(1 + 3):
            t0 = time.perf_counter()
            outs[mode] = gen.eval_points(model, pts, c, *gates[mode],
                                         transfer_dtype=torch.float32)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        log("planes", eval_points_n=PLANES_EVAL_N, mode=mode,
            call_s=float(np.median(times[1:])), call_s_each=times[1:], first_call_s=times[0])
    eval_launches = read_counters()
    launched_only("planes_eval_points", eval_launches,
                  {"fused_trunk_gated_cn": 4, "fused_trunk_cn": 4})

    # each kernel against its plain version on the plane-summed features,
    # on the mesh's grid and on the eval_points set (not counted)
    box = 1 + PADDING
    p_sets = {"grid": dense_query_grid_cn(nx, box, device=dev),
              "points": torch.as_tensor(np.ascontiguousarray(pts.T), device=dev)}
    with torch.no_grad():
        for where, p_cn in p_sets.items():
            feats = (dense_feature_volume_cn(c, nx, box, PADDING) if where == "grid"
                     else scattered_feature_volume_cn(c, p_cn, PADDING))
            for mode, (gating, gp, gf, gv) in gates.items():
                tp = FT.extract_trunk_params(model.decoder, with_img=gating != "none")
                if gating == "contact":
                    got = K.fused_trunk_gated_cn(tp, p_cn, feats, gp, gf, gv)
                    want = plain_gated(tp, p_cn, feats, gp, gf, gv, RADIUS)
                    _, gated, keep = gate_stats(p_cn, gp, gv, RADIUS)
                else:
                    got = K.fused_trunk_cn(tp, p_cn, feats)
                    want, gated, keep = FT.trunk_cn(tp, p_cn, feats), 0, None
                err = max_err(got, want, keep)
                if where == "points":   # eval_points' logits are the kernel's
                    err_ep = float(np.abs(outs[mode] - got.cpu().numpy()).max())
                    if err_ep > ATOL:
                        raise AssertionError(f"planes: eval_points {mode} {err_ep}")
                log("planes", kernel=("fused_trunk_gated_cn" if gating == "contact"
                                      else "fused_trunk_cn"), on=where, n=p_cn.shape[1],
                    max_abs_err=err, gated_points=gated,
                    near_radius=0 if keep is None else int((~keep).sum()),
                    feature_min=float(feats.min()), feature_max=float(feats.max()))
    return mesh_launches, eval_launches


def lattice_points(dev, g, n, R):
    """n random nodes of the R^3 refinement lattice in C order (as MISE
    queries them) → (3, n) world coords box (i / R - 0.5)."""
    idx, _ = torch.sort(torch.randint(0, (R + 1) ** 3, (n,), generator=g, device=dev))
    ijk = torch.stack([idx // (R + 1) ** 2, idx // (R + 1) % (R + 1), idx % (R + 1)])
    return (1 + PADDING) * (ijk.float() / R - 0.5)


def batched_kernel_phase(dev, peak):
    """(a) K2 over BATCH_B objects in one launch (fused_trunk_cn_batched)
    against its plain version (trunk_cn per object) on the shared 128^3
    grid and on BATCH_B objects' own BATCH_LATTICE_N lattice points (the
    512^3 lattice of MISE's last level), then timed against BATCH_B
    single-object K2 launches on the same inputs."""
    tp = FT.extract_trunk_params(random_decoder(dev, seed=0), with_img=False)
    g = torch.Generator(device=dev).manual_seed(13)
    grid = dense_query_grid_cn(LATTICE_NX, 1 + PADDING, device=dev)
    B = BATCH_B
    cases = {
        "grid": [(grid, torch.randn((B, WIDTH, N_FLAGSHIP), generator=g, device=dev))
                 for _ in range(2)],
        "lattice": [(torch.stack([lattice_points(dev, g, BATCH_LATTICE_N, 512)
                                  for _ in range(B)]),
                     torch.randn((B, WIDTH, BATCH_LATTICE_N), generator=g, device=dev))
                    for _ in range(2)]}

    def singles(p, f):
        return [K.fused_trunk_cn(tp, p if p.dim() == 2 else p[b], f[b]) for b in range(B)]

    def plain(p, f):
        return torch.stack([FT.trunk_cn(tp, p if p.dim() == 2 else p[b], f[b])
                            for b in range(B)])

    out = {}
    with torch.no_grad():
        for name, sets in cases.items():
            errs = [max_err(K.fused_trunk_cn_batched(tp, p, f), plain(p, f))
                    for p, f in sets]
            ms = cuda_ms(lambda p, f: K.fused_trunk_cn_batched(tp, p, f), sets, 20)
            singles_ms = cuda_ms(singles, sets, 20)
            plain_ms = cuda_ms(plain, sets, 2)
            p, f = sets[0]
            n = f.shape[-1]
            work = trunk_work(B * n, False)
            if p.dim() == 2:          # one grid read for every object
                work[2] -= (B - 1) * 3 * n * 4
            out[name] = kernel_row(max(errs), ms, plain_ms, work, peak)
            out[name]["singles_ms"] = singles_ms
            log("batched", kernel="fused_trunk_cn_batched", case=name, B=B, N=n,
                coords="shared" if p.dim() == 2 else "per object", max_abs_err=max(errs),
                ms=ms, singles_ms=singles_ms, plain_ms=plain_ms,
                bound_ms=out[name]["bound_ms"], bound_by=out[name]["bound_by"])
    del cases
    row = dict(out["grid"])
    row["lattice_ms"] = out["lattice"]["ms"]
    row["lattice_bound_ms"] = out["lattice"]["bound_ms"]
    row["lattice_singles_ms"] = out["lattice"]["singles_ms"]
    row["err"] = max(out["grid"]["err"], out["lattice"]["err"])
    return row


def mise_model(model):
    """The flagship model with its decoder's feature conditioning (fc_c)
    damped by MISE_GAIN, as tests/test_torch_generate.py damps it: the
    field is then dominated by its smooth response to the coordinates, as
    a trained decoder's is. Random weights give a noise field whose level
    set folds through the whole box, and MISE would query nearly every
    node; damped much further (0.05), the tactile term's peaks at the
    contacts pull the midpoint level up to a few blobs around them. At
    0.3, (c)'s midpoint surface queries about as many nodes as the
    object's own (object_queries) and passes through the contacts."""
    damped = copy.deepcopy(model)
    with torch.no_grad():
        for fc in damped.decoder.fc_c:
            fc.weight.mul_(MISE_GAIN)
    return damped.eval()


def object_queries(res0, steps, box):
    """MISE's query count per level on make_batch's ellipsoid, its exact
    field 1 - |p / OBJECT_AXES| at level 0: the count a mesh of the
    object's surface queries."""
    from vtaco_tpu_torch.generate.mise import MultiGridExtractor

    def field(pts, R):
        w = box * (pts / R - 0.5)
        return (1.0 - np.linalg.norm(w / np.array(OBJECT_AXES), axis=1)).astype(np.float32)

    mg = MultiGridExtractor(res0, 0.0, invert=False)
    pts = mg.query()
    mg.update(pts, field(pts, mg.resolution))
    counts = []
    for _ in range(steps):
        mg.increase_resolution()
        pts = mg.query()
        counts.append(len(pts))
        mg.update(pts, field(pts, mg.resolution))
    return counts


def zero_counters():
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)
    K.fused_trunk_cn.launches_cimg = K.fused_trunk_window_cn.launches_cimg = 0
    K.fused_trunk_cn.launches_generic_cimg = 0
    K.fused_trunk_window_cn.launches_generic_cimg = 0


def launched_only(phase, launches, want):
    """Raises unless the counters read ``want`` ({name: launches}) and
    nothing else launched."""
    got = {k: v for k, v in launches.items() if v}
    if got != {k: v for k, v in want.items() if v} or min(want.values()) < 1:
        raise AssertionError(f"{phase}: launched {got}, expected {want}")


def settled_mask(got, want, thr_got, thr_want, near=1e-5):
    """The grid points no undecided value can reach (values within
    ``near`` of their level may be decided either way, which changes the
    points decoded around them up to three fine voxels away), and the
    count of such values."""
    from scipy.ndimage import binary_dilation

    undecided = (np.abs(got - thr_got) < near) | (np.abs(want - thr_want) < near)
    keep = ~binary_dilation(undecided, np.ones((3, 3, 3), bool), iterations=3)
    return keep, int(undecided.sum())


def batched_phase(dev, peak, cfg, model):
    """(b)-(d): VTacO_YCB at full width on BATCH_B objects (make_batch
    from seeds 0..BATCH_B-1), the decoder damped (mise_model): (b)
    decode_dense_batched at nx = 128 against eval_points_dense per
    object; (c) generate_obj_mesh_mise at the config's default (128
    coarse, upsampling_steps 2: 513^3), contact-gated, and the refinement
    values at the queried points against eval_points_fast on their world
    coordinates; (d) multires_decode_batched at 64 coarse with 2 levels
    (257^3) against multires_decode per object. Counters are zeroed just
    before each run and read just after. Returns the launches by path."""
    from vtaco_tpu_torch.generate.mise import multires_decode, multires_decode_batched

    mmodel = mise_model(model)
    cfg_none = json.loads(json.dumps(cfg))
    cfg_none["model"]["with_img"] = False
    gen, gen_none = get_generator(mmodel, cfg), get_generator(mmodel, cfg_none)
    batches = [make_batch(np.random.default_rng(s), cfg) for s in range(BATCH_B)]
    with torch.no_grad():
        c = mmodel.encode_inputs(torch.as_tensor(
            np.concatenate([b["inputs"] for b in batches]), device=dev))
    nx, B = LATTICE_NX, BATCH_B
    paths = {}

    # (b) the batched dense decode
    f32 = torch.float32
    gen_none.decode_dense_batched(mmodel, nx, c, transfer_dtype=f32)      # warm
    zero_counters()
    times, outs = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        outs.append(gen_none.decode_dense_batched(mmodel, nx, c, transfer_dtype=f32))
        times.append(time.perf_counter() - t0)
    paths["dense_batched"] = launches = read_counters()
    launched_only("dense_batched", launches, {"fused_trunk_cn_batched": 3})
    t0 = time.perf_counter()
    singles = [gen_none.eval_points_dense(mmodel, nx, {"grid": c["grid"][b:b + 1]},
                                          transfer_dtype=f32) for b in range(B)]
    singles_s = time.perf_counter() - t0
    err = max(float(np.abs(outs[-1][b] - singles[b]).max()) for b in range(B))
    log("batched", path="decode_dense_batched", B=B, nx=nx, call_s=float(np.median(times)),
        call_s_each=times, singles_s=singles_s, vs_eval_points_dense=err,
        equal=all(np.array_equal(outs[-1][b], singles[b]) for b in range(B)),
        **{f"launches_{k}": v for k, v in launches.items() if v})
    if not (err <= ATOL and all(np.array_equal(o, outs[-1]) for o in outs)):
        raise AssertionError(f"decode_dense_batched disagrees with eval_points_dense: {err}")
    del outs, singles

    # (c) the MISE mesh at 513^3, contact-gated (K1)
    res0, steps = gen.resolution0 * 4, gen.upsampling_steps
    reso = res0 << steps
    gen.generate_obj_mesh_mise(mmodel, batches[0])                        # cold
    zero_counters()
    st = {}
    t0 = time.perf_counter()
    verts, faces = gen.generate_obj_mesh_mise(mmodel, batches[0], stats=st)
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    paths["mise_mesh"] = launches = read_counters()
    levels = sum(1 for q in st["query_pts"] if q)
    launched_only("mise_mesh", launches, {"fused_trunk_gated_cn": 1 + levels})
    if not (len(faces) > 0 and np.isfinite(verts).all() and np.abs(verts).max() <= 0.56):
        raise AssertionError(f"mise: bad mesh of {len(verts)} vertices, {len(faces)} faces")
    box = 1 + gen.padding
    expected = object_queries(res0, steps, box)
    log("mise", res0=res0, upsampling_steps=steps, reso=reso, mesh_s=mesh_s,
        coarse_s=st["coarse_s"], decode_s=st["decode_s"], host_s=st["host_s"],
        marching_cubes_s=st["marching_cubes_s"], query_pts=st["query_pts"],
        object_query_pts=expected, dense_pts=(reso + 1) ** 3, verts=len(verts),
        faces=len(faces), **{f"launches_{k}": v for k, v in launches.items() if v})
    if any(q < MISE_SPAN * e for q, e in zip(st["query_pts"], expected)):
        raise AssertionError(f"mise: the surface queries {st['query_pts']} nodes, under "
                             f"{MISE_SPAN} of the object's {expected}")
    # the values the levels recorded against eval_points_fast on the same
    # points as float world coordinates (another encoding and route)
    with torch.no_grad():
        cm, gates = gen._encode_sample(mmodel, batches[0], 0)
    calls, fast = [], gen.eval_points_fast

    def recorded(model_, pts, *a, **kw):
        out = fast(model_, pts, *a, **kw)
        calls.append((np.array(pts), kw["lattice_reso"], out))
        return out

    gen.eval_points_fast = recorded
    try:
        values, thr = multires_decode(gen, mmodel, cm, res0, steps, "midpoint", *gates)
    finally:
        del gen.eval_points_fast
    for pts, R, vals in calls:
        at = pts * (reso // R)
        kept = np.array(values[at[:, 0], at[:, 1], at[:, 2]])
        world = (box * (pts.astype(np.float32) / np.float32(R) - np.float32(0.5))).astype(
            np.float32)
        again = gen.eval_points_fast(mmodel, world, cm, *gates, transfer_dtype=f32,
                                     detect_lattice=False)
        _, gated, keep = gate_stats(torch.as_tensor(world.T.copy(), device=dev),
                                    gates[1], gates[3], RADIUS)
        keep = keep.cpu().numpy()
        err = float(np.abs(again - vals)[keep].max())
        log("mise", level_reso=R, query_pts=len(pts), kept_equal=bool(np.array_equal(kept, vals)),
            vs_float_coords=err, gated_points=gated, near_radius=int((~keep).sum()))
        if not (np.array_equal(kept, vals) and err <= ATOL and gated > 0):
            raise AssertionError(f"mise level {R}: grid {np.array_equal(kept, vals)}, "
                                 f"{err}, {gated} points gated")
    del values, calls

    # (d) batched MISE at 64 coarse, 2 levels, against MISE per object
    zero_counters()
    st = {}
    t0 = time.perf_counter()
    grids, thrs = multires_decode_batched(gen_none, mmodel, c, 64, 2, None, stats=st)
    batched_s = time.perf_counter() - t0
    paths["mise_batched"] = launches = read_counters()
    levels = sum(1 for q in st["query_pts"] if q)
    launched_only("mise_batched", launches, {"fused_trunk_cn_batched": 1 + levels})
    t0 = time.perf_counter()
    single = [multires_decode(gen_none, mmodel, {"grid": c["grid"][b:b + 1]}, 64, 2, None)
              for b in range(B)]
    single_s = time.perf_counter() - t0
    errs, n_near, kept = [], 0, []
    for (g1, t1), g2, t2 in zip(single, grids, thrs):
        g1, g2 = np.array(g1), np.array(g2)
        keep, near = settled_mask(g2, g1, t2, t1)
        n_near += near
        kept.append(float(keep.mean()))
        if abs(t1 - t2) > 1e-6 or not np.array_equal((g2 >= t2)[keep], (g1 >= t1)[keep]):
            raise AssertionError("batched MISE occupies other points than MISE per object")
        errs.append(float(np.abs(g2 - g1)[keep].max()))
    log("mise_batched", B=B, res0=64, upsampling_steps=2, reso=256, batched_s=batched_s,
        singles_s=single_s, coarse_s=st["coarse_s"], decode_s=st["decode_s"],
        host_s=st["host_s"], query_pts=st["query_pts"],
        object_query_pts=object_queries(64, 2, box), vs_per_object=max(errs),
        near_level=n_near, settled_share=kept,
        **{f"launches_{k}": v for k, v in launches.items() if v})
    if max(errs) > ATOL:
        raise AssertionError(f"batched MISE disagrees with MISE per object: {max(errs)}")
    return paths


# ---------------------------------------------------------------------------
# the iso-band transfer (generation.band_transfer) and the option branches

def band_generators(model, cfg, mode):
    """(the full-transfer generator, the band one) of ``mode`` ('contact':
    cfg as it is; 'none': with_img off; 'tips': a VTacOH cfg)."""
    cfg = json.loads(json.dumps(cfg))
    if mode == "none":
        cfg["model"]["with_img"] = False
    return (get_generator(model, cfg, band_transfer=False),
            get_generator(model, cfg, band_transfer=True))


def band_mesh(dev, mode, model, cfg, batch, want_kernel):
    """(a) one mode: generate_obj_mesh_wnf with band_transfer true (counters
    zeroed just before, read just after) against band_transfer false, bit
    for bit with the same chamfer and EMD and no overflow; then the band's
    count, cap and payload, its extraction on the card (CUDA events), the
    fetch of each payload, the band and volume marching cubes, and the
    host syncs of eval_points_dense_band up to its payload fetch. Returns
    the launches."""
    full, band = band_generators(model, cfg, mode)
    nx = band.resolution0 * 4
    np.random.seed(0)
    t0 = time.perf_counter()
    (vf, ff), emd_f, cd_f = full.generate_obj_mesh_wnf(model, batch)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    zero_counters()
    np.random.seed(0)
    t0 = time.perf_counter()
    (vb, fb), emd_b, cd_b = band.generate_obj_mesh_wnf(model, batch)
    torch.cuda.synchronize()
    band_s = time.perf_counter() - t0
    launches = read_counters()
    check_mesh(f"band_{mode}", vb, fb, emd_b, cd_b, nx)
    equal = (np.array_equal(vb, vf) and np.array_equal(fb, ff) and emd_b == emd_f
             and cd_b == cd_f)

    with torch.no_grad():
        c, gates = band._encode_sample(model, batch, 0)
        cap = B.default_cap(nx)
        tp = FT.extract_trunk_params(model.decoder, with_img=gates[0] != "none")
        logits = band._decode_dense_fast_impl(tp, c, *gates[1:], nx, gates[0],
                                              torch.float32, False)
        extract_ms = cuda_ms(lambda x: band._band_payload(x, nx, cap), [(logits,)], 10)
        payload = band._band_payload(logits, nx, cap)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = payload.cpu().numpy()
        band_fetch_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        volume = logits.cpu().numpy().reshape(nx, nx, nx)
        full_fetch_ms = (time.perf_counter() - t0) * 1e3
        count, level, packed, vals = B.band_unpack(host, nx, cap)
        t0 = time.perf_counter()
        mesh_band = B.band_marching_cubes(nx, level, count, packed, vals)
        band_mc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mesh_full = marching_cubes(volume, level=level)
        volume_mc_s = time.perf_counter() - t0
        _, syncs = host_syncs(band.eval_points_dense_band, model, nx, c, *gates, mesh=True)
    same_scan = all(np.array_equal(a, b) for a, b in zip(mesh_band, mesh_full))
    log("band", mode=mode, nx=nx, count=count, cap=cap, payload_bytes=len(host),
        full_bytes=volume.nbytes, payload_ratio=volume.nbytes / len(host),
        extract_ms=extract_ms, band_fetch_ms=band_fetch_ms, full_fetch_ms=full_fetch_ms,
        band_mc_s=band_mc_s, volume_mc_s=volume_mc_s, mesh_s_band=band_s,
        mesh_s_full=full_s, verts=len(vb), faces=len(fb), chamfer=cd_b, emd=emd_b,
        equal_to_full=equal, scan_equal=same_scan, band_overflows=band.band_overflows,
        host_syncs=len(syncs), sync_sites=syncs,
        **{f"launches_{k}": v for k, v in launches.items() if v})
    if not (equal and same_scan and band.band_overflows == 0 and count <= cap
            and len(host) == B.payload_bytes(nx, cap)):
        raise AssertionError(f"band {mode}: equal {equal}, scan {same_scan}, "
                             f"{band.band_overflows} overflows, count {count} of {cap}")
    launched_only(f"band {mode}", launches, {want_kernel: 1})
    return launches, (band, c, gates, nx)


def band_phase(dev, cfg, model, batch):
    """band (after batched): the iso-band transfer at full width on
    VTacO_YCB's random weights with the decoder damped as in (c) of
    batched (mise_model: a surface of the object's size, as a trained
    decoder's), under deterministic algorithms:
    (a) a mesh contact-gated (K1) and ungated (K2) with band_transfer true
    against false (band_mesh); (b) eval_points_dense_band with cap 1:
    band_overflows 1 and the grid of the full float32 transfer; (c)
    decode_dense_batched_band on BATCH_B objects at nx = 128, blocking and
    with return_device plus finish_batched_band(mesh=True), each mesh equal
    to marching cubes of decode_dense_batched's float32 transfer at the
    same level. (e) of the phase is options_phase. Returns the launches by
    path."""
    mmodel = mise_model(model)
    t_phase = time.perf_counter()
    paths = {}
    with deterministic() as ops:
        paths["band_mesh"], (band, c, gates, nx) = band_mesh(
            dev, "contact", mmodel, cfg, batch, "fused_trunk_gated_cn")
        paths["band_mesh_none"], _ = band_mesh(dev, "none", mmodel, cfg, batch,
                                               "fused_trunk_cn")

        # (b) overflow
        with torch.no_grad():
            grid, _ = band.eval_points_dense_band(mmodel, nx, c, *gates, cap=1)
            full = band.eval_points_dense(mmodel, nx, c, *gates, transfer_dtype=torch.float32)
        overflow_equal = bool(np.array_equal(grid.reshape(-1), full))
        log("band", case="overflow", cap=1, band_overflows=band.band_overflows,
            equal_to_full=overflow_equal)
        if band.band_overflows != 1 or not overflow_equal:
            raise AssertionError(f"band overflow: {band.band_overflows} overflows, "
                                 f"grid equal {overflow_equal}")

        # (c) batched
        _, gen = band_generators(mmodel, cfg, "none")
        batches = [make_batch(np.random.default_rng(s), cfg) for s in range(BATCH_B)]
        with torch.no_grad():
            cb = mmodel.encode_inputs(torch.as_tensor(
                np.concatenate([b["inputs"] for b in batches]), device=dev))
        t0 = time.perf_counter()
        full = gen.decode_dense_batched(mmodel, LATTICE_NX, cb, transfer_dtype=torch.float32)
        full_s = time.perf_counter() - t0
        zero_counters()
        t0 = time.perf_counter()
        grids, levels = gen.decode_dense_batched_band(mmodel, LATTICE_NX, cb)
        band_s = time.perf_counter() - t0
        raw, fin = gen.decode_dense_batched_band(mmodel, LATTICE_NX, cb, return_device=True)
        t0 = time.perf_counter()
        meshes, levels2 = gen.finish_batched_band(mmodel, raw, fin, mesh=True)
        finish_s = time.perf_counter() - t0
        paths["band_batched"] = launches = read_counters()
        n = LATTICE_NX
        equal = levels == levels2
        for b in range(BATCH_B):
            fb = full[b].reshape(n, n, n)
            level = float(np.float32((float(fb.min()) + float(fb.max())) / 2))
            want = marching_cubes(fb, level=level)
            got = marching_cubes(grids[b], level=levels[b])
            equal = equal and levels[b] == level and len(want[1]) > 0 and all(
                np.array_equal(x, y) and np.array_equal(x, z)
                for x, y, z in zip(want, got, meshes[b]))
        log("band", case="batched", B=BATCH_B, nx=n, band_s=band_s, finish_mesh_s=finish_s,
            full_f32_s=full_s, payload_bytes=int(raw.shape[1]), full_bytes=n ** 3 * 4,
            equal_to_full=equal, band_overflows=gen.band_overflows,
            **{f"launches_{k}": v for k, v in launches.items() if v})
        if not equal or gen.band_overflows:
            raise AssertionError(f"band batched: equal {equal}, {gen.band_overflows} "
                                 "overflows")
        launched_only("band batched", launches, {"fused_trunk_cn_batched": 2})
    log("band", nondeterministic_ops=ops, seconds=time.perf_counter() - t_phase)
    return paths


def band_tips(dev, cfg, model, batch):
    """(a) of band for VTacOH (K2 on gate_tips_cn's rows), the decoder
    damped likewise. Returns the launches."""
    with deterministic() as ops:
        launches, _ = band_mesh(dev, "tips", mise_model(model), cfg, batch,
                                "fused_trunk_cn:c_img")
    log("band", mode="tips", nondeterministic_ops=ops)
    return launches


def band_cli_stage(root, vt):
    """(d) of band: cli.generate --batched BATCH_CLI on VTacO_YCB's test
    split from (b)'s checkpoint with generation.band_transfer true, against
    the same run with band_transfer false at float32 transfers (the
    batched_cli stage's own transfer is bfloat16, whose meshes differ from
    the float32 ones the band reproduces): the same chamfer and the same
    mesh files byte for byte, K2 batched once per flight; the overflows
    (an object whose band outgrows its buffer takes the float32 transfer
    of its logits) are logged."""
    from vtaco_tpu_torch.data.core import Shapes3dDataset
    from vtaco_tpu_torch.generate.generator import Generator3D

    cfg, ckpt = vt
    cfg = json.loads(json.dumps(cfg))
    cfg["training"]["n_workers_val"] = 1      # one loader thread: see seeded
    # run_batched's full transfer marches at the midpoint whatever mc_level
    # says, its band route at mc_level, as in the JAX package (the stage's
    # config says 'mean')
    cfg["generation"]["mc_level"] = "midpoint"
    band_cfg = json.loads(json.dumps(cfg))
    band_cfg["generation"]["band_transfer"] = True
    finish, decode = Generator3D.finish_batched_band, Generator3D.decode_dense_batched
    item = Shapes3dDataset.__getitem__
    overflows = []

    def seeded(self, idx):
        # each item's input subsample and noise from its own seed, on one
        # loader thread: threads share numpy's global state, so two runs
        # would draw differently
        np.random.seed(100 + idx)
        return item(self, idx)

    def counted(self, *a, **kw):
        out = finish(self, *a, **kw)
        overflows.append(self.band_overflows)
        return out

    def f32(self, *a, **kw):
        return decode(self, *a, **dict(kw, transfer_dtype=torch.float32))

    Shapes3dDataset.__getitem__ = seeded
    try:
        with deterministic() as ops:
            zero_counters()
            Generator3D.finish_batched_band = counted
            try:
                line_b, files_b, s_b = cli_generate(root, band_cfg, ckpt, "generate_band",
                                                    "--batched", str(BATCH_CLI))
            finally:
                Generator3D.finish_batched_band = finish
            launches = read_counters()
            Generator3D.decode_dense_batched = f32
            try:
                line_f, files_f, s_f = cli_generate(root, cfg, ckpt, "generate_band_f32",
                                                    "--batched", str(BATCH_CLI))
            finally:
                Generator3D.decode_dense_batched = decode
    finally:
        Shapes3dDataset.__getitem__ = item
    same = files_b == files_f and all(
        open(os.path.join(root, "generate_band", f), "rb").read()
        == open(os.path.join(root, "generate_band_f32", f), "rb").read() for f in files_b)
    flights = -(-line_b["n"] // BATCH_CLI)
    log("band_cli", cd_mean_band=line_b["cd_mean"], cd_mean_f32=line_f["cd_mean"],
        n=line_b["n"], cli_s_band=s_b, cli_s_f32=s_f, files_equal=same,
        band_overflows=max(overflows or [0]), nondeterministic_ops=ops,
        **{f"launches_{k}": v for k, v in launches.items() if v})
    if not (same and line_b["cd_mean"] == line_f["cd_mean"] and np.isfinite(line_b["cd_mean"])
            and len(overflows) == flights):
        raise AssertionError(f"band cli: {line_b} against {line_f}, files equal {same}, "
                             f"overflows {overflows}")
    launched_only("band cli", launches, {"fused_trunk_cn_batched": flights})
    return launches


def options_phase(dev, cfg):
    """(e) of band: the option branches at VTacO_YCB's UNet3D widths
    (f_maps 32, 32 channels in and out) on a 64^3 grid, one forward each on
    the card against the CPU at 'highest' (within 1e-4 of the largest
    value): UNet3D with layer order 'cbr' (train-mode BatchNorm) and
    ResidualUNet3D (basic_module ext_resnet) at one level, and at the
    config's four levels the raise of F9 (c)."""
    from vtaco_tpu_torch.models.unet3d import build_unet3d

    kw = dict(cfg["model"]["encoder_kwargs"]["unet3d_kwargs"])
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, kw["in_channels"], 64, 64, 64, generator=g)
    out = {}
    for name, over in (("cbr", dict(layer_order="cbr")),
                       ("ext_resnet", dict(basic_module="ext_resnet", num_levels=1))):
        torch.manual_seed(0)
        net = build_unet3d(dict(kw, **over)).train()
        cpu = copy.deepcopy(net)
        with torch.no_grad(), matmul_precision("highest"):
            t0 = time.perf_counter()
            got = net.to(dev)(x.to(dev)).cpu()
            card_s = time.perf_counter() - t0
            want = cpu(x)
        out[name] = float((got - want).abs().max() / want.abs().max())
        log("options", module=name, rel_err=out[name], card_s=card_s, shape=list(got.shape))
    try:
        build_unet3d(dict(kw, basic_module="ext_resnet")).to(dev)(x.to(dev))
        raised = None
    except NotImplementedError as e:
        raised = str(e)
    log("options", ext_resnet_levels=kw["num_levels"], raised=raised)
    if max(out.values()) > 1e-4 or raised is None or "F9 (c)" not in raised:
        raise AssertionError(f"options: {out}, raised {raised}")


def batched_cli_stage(root, vt):
    """(h) cli.generate --batched BATCH_CLI on VTacO_YCB's test split from
    (b)'s checkpoint, then on its train split (more flights): the last
    JSON line, an object mesh per object, K2 batched once per flight and
    nothing else (counters zeroed just before, read just after), objects
    per second of Inferencer.run_batched, and its pipelining: each
    flight's decode between CUDA events and the host's time to enqueue it,
    and, when the host work of flight k starts, whether flight k+1's
    decode is still running on the card. Returns the launches."""
    from vtaco_tpu_torch.generate import inferencer as inf
    from vtaco_tpu_torch.generate.generator import Generator3D

    cfg, ckpt = vt
    decode, host_map = Generator3D.decode_dense_batched, inf.host_map
    total = {}
    for split in ("test", "train"):
        order, flights, host_work = [], [], []

        def timed_decode(self, *a, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = decode(self, *a, **kw)
            end.record()
            order.append(("decode", len(flights)))
            flights.append((start, end, (time.perf_counter() - t0) * 1e3))
            return out

        def timed_host_map(fn, *seqs):
            k = len(host_work)
            order.append(("host", k))
            running = k + 1 < len(flights) and not flights[k + 1][1].query()
            t0 = time.perf_counter()
            out = host_map(fn, *seqs)
            host_work.append((time.perf_counter() - t0, running))
            return out

        Generator3D.decode_dense_batched, inf.host_map = timed_decode, timed_host_map
        zero_counters()
        try:
            with timed_methods(inf.Inferencer, ("run_batched",)) as t, \
                    timed_methods(type(native.mc), ("marching_cubes",), sync=False) as mc:
                line, files, seconds = cli_generate(
                    root, cfg, ckpt, f"generate_batched_{split}", "--split", split,
                    "--batched", str(BATCH_CLI))
        finally:
            Generator3D.decode_dense_batched, inf.host_map = decode, host_map
        launches = read_counters()
        n, n_flights = line["n"], len(flights)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        run_s = t["run_batched"][0]
        decode_ms = [s.elapsed_time(e) for s, e, _ in flights]
        overlapped = [r for _, r in host_work[:-1]]
        log("batched_cli", config="configs/VTacO/VTacO_YCB.yaml", cli_s=seconds, run_batched_s=run_s, objects_per_s=n / run_s,
            flights=n_flights, decode_ms_each=decode_ms,
            decode_enqueue_ms_each=[h for _, _, h in flights],
            host_work_s_each=[h for h, _ in host_work],
            marching_cubes_s_each=mc["marching_cubes"],
            next_flight_running_at_host_work=overlapped, **line,
            **{f"launches_{k}": v for k, v in launches.items() if v})
        if not (n >= 1 and line["batched"] == BATCH_CLI and np.isfinite(line["cd_mean"])
                and len(files) == n and n_flights == -(-n // BATCH_CLI)):
            raise AssertionError(f"batched cli: bad result {line}, {files}")
        for f in files:
            verts, faces = meshio.read_off(os.path.join(root, f"generate_batched_{split}", f))
            if len(faces) == 0 or not np.isfinite(verts).all():
                raise AssertionError(f"batched cli: bad mesh {f}")
        # flight k + 1 is launched before flight k's host work
        if any(order.index(("decode", k + 1)) > order.index(("host", k))
               for k in range(n_flights - 1)):
            raise AssertionError(f"batched cli: not pipelined: {order}")
        launched_only(f"batched cli {split}", launches, {"fused_trunk_cn_batched": n_flights})
    return total


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def parallel_phase(root, data, vt):
    """(k) The parallel modules on one card: a one-rank NCCL group from a
    file store and ``make_mesh(data=1)`` passed explicitly
    (``mesh_from_config`` gives None on one card, as the JAX package's
    does), so every collective of the data-parallel paths runs at a world
    of one. (a) VTacO_YCB's train step at full width (batch 3, 'highest')
    through Trainer(device_mesh=...) against the same step from the same
    weights, batch and draws without a mesh, both under deterministic
    algorithms: loss scalars within
    PARALLEL_RTOL relative, each module's gradient cosine >=
    PARALLEL_COS; then the step's time with and without the mesh, in
    turns: the collectives' cost at a world of one, and two steps of each
    under torch.profiler (device time, busy share, launches). (b) VTacO_YCB_fast's
    fused block of 8 under the mesh: no host sync inside it, finite
    scalars. (c) eval_points_dense_sharded at nx = 128 through K2, within
    one bfloat16 step of eval_points_dense's ungated grid; (d)
    decode_dense_batched at BATCH_B x 128^3 and multires_decode_batched at
    257^3 under the mesh, each equal to the call without one; (e)
    Inferencer.run_batched over the mesh on the test split, the result of
    the run without one (both under deterministic algorithms). The references run first; the counters are
    zeroed just before (c)-(e) and read just after. Every line carries
    the card's name and power limit. Returns the launches."""
    import torch.distributed as dist

    from vtaco_tpu_torch.generate.inferencer import Inferencer
    from vtaco_tpu_torch.generate.mise import multires_decode_batched
    from vtaco_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    card = smi_line()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="file://" + os.path.join(root, "nccl_store"),
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(data=1)
        log("parallel", card=repr(card), mesh=mesh.shape, backend=dist.get_backend())

        # (a) the train step with and without the mesh
        cfg = pipeline_config("configs/VTacO/VTacO_YCB.yaml", root, data, "parallel")
        cfg["training"]["matmul_precision"] = "highest"
        bs = cfg["training"]["batch_size"]
        torch.manual_seed(0)
        model = get_model(cfg)
        bank = loop.build_mesh_bank(cfg, "cuda")
        plain = Trainer.from_config(copy.deepcopy(model), cfg, mesh_bank=bank, seed=0)
        meshed = Trainer.from_config(model, cfg, mesh_bank=bank, seed=0, device_mesh=mesh)
        batches = take(BatchLoader(get_dataset("train", cfg), bs, num_workers=4, seed=1),
                       1 + 2 * PARALLEL_STEPS)
        # deterministic kernels: the scatter's atomics would move the
        # encoder's gradient between any two runs
        with deterministic() as nondeterministic:
            want, got = plain.train_step(batches[0]), meshed.train_step(batches[0])
        rel = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in want}
        cos, ratio = module_cosines(meshed.model, plain.model)
        log("parallel", card=repr(card), step="train", batch_size=bs,
            nondeterministic_ops=nondeterministic, **rel)
        log("parallel", card=repr(card), grad_cosine=cos, grad_norm_ratio=ratio)
        if max(rel.values()) > PARALLEL_RTOL or min(cos.values()) < PARALLEL_COS or set(
                cos) != {"encoder", "encoder_hand", "encoder_img", "decoder"}:
            raise AssertionError(f"parallel: the step under the mesh differs: {rel} {cos}")
        times = {"plain": [], "mesh": []}
        for i, b in enumerate(batches[1:]):
            for name in (("plain", "mesh") if i % 2 == 0 else ("mesh", "plain")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                (plain if name == "plain" else meshed).train_step(b)
                torch.cuda.synchronize()
                times[name].append(time.perf_counter() - t0)
        step = {k: float(np.median(v[1:])) for k, v in times.items()}
        log("parallel", card=repr(card), step_s=step["plain"], mesh_step_s=step["mesh"],
            collectives_s=step["mesh"] - step["plain"], step_s_each=times["plain"],
            mesh_step_s_each=times["mesh"])
        for name, tr in (("plain", plain), ("mesh", meshed)):
            wall, busy, n_launch = profiled(
                lambda tr=tr: [tr.train_step(b) for b in batches[1:3]], 2)
            log("parallel", card=repr(card), profiled=name, steps=2, wall_s=wall,
                kernel_s=busy, device_busy_share=busy / wall,
                kernel_launches_per_step=n_launch)
        del plain, meshed, model

        # (b) the fused block of VTacO_YCB_fast under the mesh
        fcfg = pipeline_config("configs/VTacO/VTacO_YCB_fast.yaml", root, data,
                               "parallel_fast")
        k = int(fcfg["training"]["steps_per_dispatch"])
        n_points, n_cloud = fcfg["data"]["points_subsample"], fcfg["data"]["pointcloud_n"]
        trainer = Trainer.from_config(get_model(fcfg), fcfg, mesh_bank=bank, seed=0,
                                      device_mesh=mesh)
        dds = DeviceDataset(get_dataset("train", fcfg), device="cuda",
                            pointcloud_noise=fcfg["data"]["pointcloud_noise"])
        dloader = DeviceBatchLoader(dds, fcfg["training"]["batch_size"], n_points, n_cloud,
                                    seed=1)
        fused = trainer.make_fused_train_fn(dds, n_points, n_cloud)
        trainer.read_scalars(fused(dloader.take_ids(k), dloader.next_key()))    # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stacked, syncs = host_syncs(fused, dloader.take_ids(k), dloader.next_key())
        scal = trainer.read_scalars(stacked)
        block_s = time.perf_counter() - t0
        log("parallel", card=repr(card), fused_block_steps=k, fused_step_s=block_s / k,
            host_syncs_per_block=len(syncs), loss_each=scal["loss"].tolist())
        if syncs or not all(v.shape == (k,) and np.isfinite(v).all() for v in scal.values()):
            raise AssertionError(f"parallel: fused block: {len(syncs)} syncs, {scal}")
        del trainer, dds, fused

        # (c)-(e): the decodes, references first
        vcfg, ckpt = vt
        model = get_model(vcfg)
        CheckpointIO(vcfg["training"]["out_dir"], model=model).load(ckpt)
        model.eval()
        gen = get_generator(model, vcfg)
        nx = PARALLEL_NX
        flight = next(iter(BatchLoader(get_dataset("train", vcfg), BATCH_B, num_workers=4,
                                       seed=2)))
        test = list(BatchLoader(get_dataset("test", vcfg, return_idx=True), 1,
                                shuffle=False, num_workers=1))
        with torch.no_grad():
            c = model.encode_inputs(torch.as_tensor(flight["inputs"], device="cuda"))
        one = {k2: v[:1] for k2, v in c.items()}
        ref_dense = gen.eval_points_dense(model, nx, one)
        ref_batched = gen.decode_dense_batched(model, nx, c)
        ref_band = gen.decode_dense_batched_band(model, nx, c)
        ref_mise = multires_decode_batched(gen, model, c, 64, 2, None)
        # deterministic kernels: each run encodes anew, and the scatter's
        # atomics would move a logit across the bfloat16 transfer's rounding
        with deterministic():
            ref_serve = Inferencer(model, gen).run_batched(
                model, test, batch_size=2, out_dir=os.path.join(root, "parallel_serve_one"))
        zero_counters()
        t0 = time.perf_counter()
        sharded = gen.eval_points_dense_sharded(model, nx, one, mesh)
        sharded_s = time.perf_counter() - t0
        batched = gen.decode_dense_batched(model, nx, c, device_mesh=mesh)
        band = gen.decode_dense_batched_band(model, nx, c, device_mesh=mesh)
        st = {}
        grids, levels = multires_decode_batched(gen, model, c, 64, 2, None, device_mesh=mesh,
                                                stats=st)
        with deterministic():
            served = Inferencer(model, gen).run_batched(
                model, test, batch_size=2, device_mesh=mesh,
                out_dir=os.path.join(root, "parallel_serve_mesh"))
        torch.cuda.synchronize()
        launches = read_counters()
        steps = np.abs(_bf16_bits(sharded) - _bf16_bits(ref_dense))
        mise_equal = levels == ref_mise[1] and all(
            np.array_equal(a, b) for a, b in zip(grids, ref_mise[0]))
        served_equal = served == ref_serve
        band_equal = band[1] == ref_band[1] and all(
            np.array_equal(a, b) for a, b in zip(band[0], ref_band[0]))
        log("parallel", card=repr(card), sharded_nx=nx, sharded_s=sharded_s,
            sharded_bf16_steps_max=int(steps.max()), sharded_points_off=int((steps > 0).sum()),
            batched_equal=bool(np.array_equal(batched, ref_batched)), mise_equal=mise_equal,
            band_equal=band_equal, served_equal=served_equal, served=served,
            **{f"launches_{k2}": v for k2, v in launches.items() if v})
        if steps.max() > 1 or not np.array_equal(batched, ref_batched) or not mise_equal or (
                not served_equal) or not band_equal:
            raise AssertionError("parallel: a decode over the mesh differs from the call "
                                 "without one")
        levels_run = sum(1 for q in st["query_pts"] if q)
        launched_only("parallel", launches, {
            "fused_trunk_cn": 1,
            "fused_trunk_cn_batched": 2 + (1 + levels_run) + -(-len(test) // 2)})
    finally:
        dist.destroy_process_group()
    log("parallel", card=repr(card), seconds=time.perf_counter() - t_phase)
    return launches


def _bf16_bits(x):
    """float32 values that hold bfloat16 ones → their bfloat16 bit
    patterns, one apart for neighbouring values of one sign."""
    return torch.as_tensor(np.ascontiguousarray(x)).to(torch.bfloat16).view(
        torch.int16).numpy().astype(np.int64)


def pipeline_config(path, root, data, run):
    """A shipped config with its data on the pipeline's synthetic set
    (``data``: the data and mesh roots), its run directory ``root/run``,
    and the loop's cadences for a short run: validation and a checkpoint at
    the last of TRAIN_LOOP_ITERS steps."""
    cfg = load_config(os.path.join(REPO, path), os.path.join(REPO, "configs/default.yaml"))
    data_root, mesh_root = data
    cfg["data"].update(path=data_root, mesh_dir=os.path.join(mesh_root, "mesh_obj"),
                       depth_origin=os.path.join(mesh_root, "depth_origin.txt"))
    cfg["training"].update(out_dir=os.path.join(root, run), print_every=1,
                           validate_every=TRAIN_LOOP_ITERS,
                           checkpoint_every=TRAIN_LOOP_ITERS, backup_every=-1,
                           n_workers=4, n_workers_val=2)
    return cfg


def printed(fn, *args, **kw):
    """(fn's result, what it printed); the output is printed here too."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out = fn(*args, **kw)
    finally:
        sys.stdout.write(buf.getvalue())
        sys.stdout.flush()
    return out, buf.getvalue()


def take(loader, n):
    """The first n batches of a loader's epochs, one epoch after another."""
    out = []
    while len(out) < n:
        for b in loader:
            out.append(b)
            if len(out) == n:
                break
    return out


def module_cosines(model, ref):
    """Each top-level module's gradient cosine and norm ratio, ``model``'s
    against ``ref``'s (same parameter names)."""
    cos, ratio = {}, {}
    ref_params = dict(ref.named_parameters())
    for mod in dict(model.named_children()):
        pairs = [(p.grad, ref_params[n].grad)
                 for n, p in model.named_parameters() if n.split(".")[0] == mod]
        if all(g is None and w is None for g, w in pairs):
            continue   # the shipped path's t2d: no gradient on either side
        if any((g is None) != (w is None) for g, w in pairs):
            raise AssertionError(f"{mod} has gradients on one side only")
        g = torch.cat([x.flatten().double().cpu() for x, _ in pairs if x is not None])
        w = torch.cat([y.flatten().double().cpu() for _, y in pairs if y is not None])
        cos[mod] = float(g @ w / (g.norm() * w.norm()))
        ratio[mod] = float(g.norm() / w.norm())
    return cos, ratio


def step_against_cpu(cfg, trainer, batch, dtype, dataset=None):
    """One train step on the card and the same step on the CPU in
    ``dtype``, from the same weights, batch and (on the t2d path) contact
    draws: the loss scalars' relative errors, each module's gradient cosine
    and norm ratio, and the CPU step's seconds (a float64 CPU step, on the
    tactile path: the loss and its backward, without the optimizer's
    update). The card runs the step in full float32 ('highest').
    ``dataset`` sets a crop model's resolution (get_model)."""
    state = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}

    def cpu_trainer(dt):
        model = get_model(cfg, device="cpu", dataset=dataset)
        model.load_state_dict(state)
        return Trainer.from_config(model.to(dt), cfg,
                                   mesh_bank=loop.build_mesh_bank(cfg, "cpu"))

    cpu = cpu_trainer(dtype)
    trainer = Trainer.from_config(trainer.model, cfg, mesh_bank=trainer.mesh_bank,
                                  matmul_precision="highest")
    draws = cpu_draws = None
    if not trainer.train_tactile and (trainer.encode_t2d or trainer.with_img):
        a = trainer.prepare_batch(batch)
        if trainer.encode_t2d:
            H, W = a["imgs"].shape[2:4]
            draws = C.contact_draws(a["depths"], a["touch_success"],
                                    trainer._depth_origin_for(H * W), a["points"].shape[1],
                                    trainer.num_sample, trainer.contact_per_finger,
                                    trainer.generator)
        else:   # the img path: the fingertip sample's draws, from the card's tips
            with torch.no_grad():
                joints = trainer.model.encode_hand_inputs(a["inputs"])["mano_joints"]
            tips = C.tips_in_object_frame(joints, a["mano"][:, :3], a["wrist"], a["pc_ply"])
            draws = C.tips_draws(C.tips_mask(a["points"], tips, a["touch_success"]),
                                 trainer.num_sample, trainer.tips_per_finger,
                                 trainer.generator)
            log("vtacoh", fingertip_slots_filled=int(
                torch.gather(C.tips_mask(a["points"], tips, a["touch_success"]), 2,
                             draws["contact_idx"]).sum()))
        cpu_draws = {k: v.cpu() for k, v in draws.items()}
    got = trainer.train_step(batch, draws)
    t0 = time.perf_counter()
    if dtype == torch.float32:
        want = cpu.train_step(batch, cpu_draws)
    elif trainer.train_tactile or not trainer.encode_t2d:
        a = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in cpu.prepare_batch(batch).items()}
        cpu.model.train()
        if trainer.train_tactile:
            loss, scalars = cpu._compute_loss_tactile(a)
        else:
            loss, scalars, _ = cpu._compute_loss_img(a, cpu_draws)
        loss.backward()
        want = cpu._host(scalars)
    else:
        raise ValueError(f"no {dtype} CPU step on the t2d path")
    cpu_s = time.perf_counter() - t0
    rel = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in want}
    cos, ratio = module_cosines(trainer.model, cpu.model)
    return rel, cos, ratio, cpu_s


def timed_steps(trainer, batches):
    """Train steps cycling through TRAIN_PRECISIONS: for each precision
    the wall times of the steps after its TRAIN_WARM warm-up steps and
    their breakdowns by the trainer's CUDA-event stage marks."""
    own = trainer.matmul_precision
    out = {p: ([], []) for p in TRAIN_PRECISIONS}
    for i, batch in enumerate(batches):
        prec = trainer.matmul_precision = TRAIN_PRECISIONS[i % len(TRAIN_PRECISIONS)]
        warm = i >= TRAIN_WARM * len(TRAIN_PRECISIONS)
        trainer.stage_events = [] if warm else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scalars = trainer.train_step(batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not all(np.isfinite(v) for v in scalars.values()):
            raise AssertionError(f"non-finite scalars at {prec}: {scalars}")
        if not warm:
            continue
        ev = trainer.stage_events
        st = {f"{name}_s": ev[j - 1][1].elapsed_time(e) / 1e3
              for j, (name, e) in enumerate(ev) if j > 0}
        st["host_outside_marks_s"] = dt - ev[0][1].elapsed_time(ev[-1][1]) / 1e3
        out[prec][0].append(dt)
        out[prec][1].append(st)
    trainer.stage_events, trainer.matmul_precision = None, own
    return out, scalars


def profile_steps(trainer, batches):
    """Train steps under torch.profiler: the wall time, the kernels' summed
    device time, kernel launches per step, and the kernels that take the
    most device time (name, ms per step, launches per step). Annotated
    ranges on the device's timeline (the optimizer's step) are left out:
    their kernels are counted already."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    n = len(batches)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    return (wall, sum(e.self_device_time_total for e in kernels) / 1e6,
            sum(e.count for e in kernels) / n,
            [(e.key[:90], e.self_device_time_total / 1e3 / n, e.count / n) for e in top])


def train_stage(phase, cfg, modules):
    """loop.train for TRAIN_LOOP_ITERS steps (the CLI's path: validation,
    model selection, checkpoint, the visualization hook), then the warm
    steps at each precision with their breakdowns and the peak memory,
    and one 'highest' step against the CPU's in TRAIN_REFERENCE[phase],
    whose gradients must reach ``modules``. Returns (trainer, the loop's
    output, the timed batches)."""
    t0 = time.perf_counter()
    (trainer, it), out = printed(loop.train, cfg, max_iters=TRAIN_LOOP_ITERS,
                                 device="cuda", seed=0,
                                 generator_factory=make_loop_generator)
    torch.cuda.synchronize()
    out_dir = cfg["training"]["out_dir"]
    for f in ("model.ckpt", "model_best.ckpt"):
        if not os.path.exists(os.path.join(out_dir, f)):
            raise AssertionError(f"{phase}: loop.train wrote no {f}")
    n_params = sum(p.numel() for p in trainer.model.parameters())
    log(phase, loop_iters=it, loop_s=time.perf_counter() - t0, params=n_params)

    bs = cfg["training"]["batch_size"]
    loader = BatchLoader(get_dataset("train", cfg), bs, num_workers=4, seed=1)
    n_steps = (TRAIN_WARM + TRAIN_TIMED) * len(TRAIN_PRECISIONS)
    batches = take(loader, n_steps + 1)
    torch.cuda.reset_peak_memory_stats()
    runs, scalars = timed_steps(trainer, batches[:n_steps])
    peak = torch.cuda.max_memory_allocated()
    log(phase, matmul_precision=trainer.matmul_precision, peak_mem_gib=peak / 2 ** 30,
        batch_size=bs, warm_up_steps=TRAIN_WARM, **scalars)
    for prec, (times, stages) in runs.items():
        log(phase, matmul_precision=prec, step_s=float(np.median(times)),
            step_s_min=min(times), step_s_max=max(times), step_s_each=times)
        for k in stages[0]:
            col = [s[k] for s in stages]
            log(phase, matmul_precision=prec, stage=k, median=float(np.median(col)),
                min=min(col), max=max(col))

    dtype = TRAIN_REFERENCE[phase]
    rel, cos, ratio, cpu_s = step_against_cpu(cfg, trainer, batches[-1], dtype)
    log(phase, vs_cpu="loss_rel_err", cpu_dtype=str(dtype)[6:], cpu_step_s=cpu_s, **rel)
    log(phase, vs_cpu="grad_cosine", **cos)
    log(phase, vs_cpu="grad_norm_ratio", **ratio)
    if max(rel.values()) > TRAIN_RTOL or min(cos.values()) < GRAD_COS:
        raise AssertionError(f"{phase}: card step differs from the CPU step: {rel} {cos}")
    if not set(modules) <= set(cos):
        raise AssertionError(f"{phase}: modules without gradients: {sorted(cos)}")
    return trainer, out, batches


def tactile_stage(root, data):
    """(a) Pretraining the tactile depth stack (tactile_test.yaml at full
    width, its batch of 12). Returns (cfg, the checkpoint's absolute
    path)."""
    cfg = pipeline_config("configs/tactile/tactile_test.yaml", root, data, "tactile")
    bs, n_train = cfg["training"]["batch_size"], len(get_dataset("train", cfg))
    log("tactile", config="configs/tactile/tactile_test.yaml", batch_size=bs,
        train_models=n_train, c_dim=cfg["model"]["c_dim"])
    if bs > n_train:
        raise AssertionError(f"tactile: the train split ({n_train}) cannot hold a batch")
    train_stage("tactile", cfg, ("encoder_hand", "encoder_img"))
    return cfg, os.path.abspath(os.path.join(cfg["training"]["out_dir"], "model.ckpt"))


def vtaco_stage(root, data, t2d_ckpt):
    """(b) VTacO_YCB at full width, its t2d stack grafted from (a)'s
    checkpoint (``model_file`` as an absolute path), with the steps' time,
    the profiler's view of them, a validation's time, the step against the
    CPU and a mesh from the checkpoint (K1). Returns (cfg, the checkpoint's
    absolute path)."""
    cfg = pipeline_config("configs/VTacO/VTacO_YCB.yaml", root, data, "vtaco")
    cfg["model"]["encoder_t2d_kwargs"]["model_file"] = t2d_ckpt
    # a field trained a few steps can miss the midpoint level
    cfg["generation"]["mc_level"] = "mean"
    log("train", config="configs/VTacO/VTacO_YCB.yaml", t2d_model_file=t2d_ckpt,
        n_query=cfg["data"]["points_subsample"], pointcloud_n=cfg["data"]["pointcloud_n"],
        num_sample=cfg["data"]["num_sample"], batch_size=cfg["training"]["batch_size"])
    trainer, out, batches = train_stage(
        "train", cfg, ("encoder", "encoder_hand", "encoder_img", "decoder"))
    if f"loaded pretrained t2d weights from {t2d_ckpt}" not in out:
        raise AssertionError("train: the t2d stack was not grafted from the tactile run")
    wall, busy, launches_per_step, top = profile_steps(trainer, batches[:TRAIN_PROFILED])
    log("train", profiled_steps=TRAIN_PROFILED, wall_s=wall, kernel_s=busy,
        device_busy_share=busy / wall, kernel_launches_per_step=launches_per_step)
    for name, ms, count in top:
        print(f"[train] kernel ms_per_step={ms:.3f} launches_per_step={count} {name}")
    t0 = time.perf_counter()
    val = trainer.evaluate(BatchLoader(get_dataset("val", cfg, return_idx=True), 1,
                                       shuffle=False, num_workers=2))
    torch.cuda.synchronize()
    log("train", validation_s=time.perf_counter() - t0, **{f"val_{k}": v for k, v in val.items()})

    # a mesh from the checkpoint, contact-gated (K1)
    ckpt = os.path.abspath(os.path.join(cfg["training"]["out_dir"], "model.ckpt"))
    model = get_model(cfg)
    CheckpointIO(cfg["training"]["out_dir"], model=model).load(ckpt)
    model.eval()
    gen = get_generator(model, cfg)
    batch = next(iter(BatchLoader(get_dataset("val", cfg, return_idx=True), 1,
                                  shuffle=False, num_workers=1)))
    K.fused_trunk_gated_cn.launches = 0
    t0 = time.perf_counter()
    np.random.seed(0)
    with torch.no_grad():
        (verts, faces), emd, cd = gen.generate_obj_mesh_wnf(model, batch)
    torch.cuda.synchronize()
    launches = K.fused_trunk_gated_cn.launches
    check_mesh("train", verts, faces, emd, cd, gen.resolution0 * 4)
    log("train", mesh_from_checkpoint_s=time.perf_counter() - t0, verts=len(verts),
        faces=len(faces), chamfer=cd, emd=emd, launches_fused_trunk_gated_cn=launches)
    if launches < 1:
        raise AssertionError("train: the checkpoint's mesh never launched K1")
    return cfg, ckpt


def vtacoh_stage(root, data):
    """(c) VTacOH_YCB at full width (no t2d stack, fingertip gating) at its
    batch of 6: the loop with validation (IoU on points_iou) and a
    checkpoint, the steps' time and the profiler's view of them, a
    validation's time and the step against the CPU. Returns (cfg, the
    checkpoint's absolute path)."""
    cfg = pipeline_config("configs/VTacOH/VTacOH_YCB.yaml", root, data, "vtacoh")
    cfg["generation"]["mc_level"] = "mean"
    bs, n_train = cfg["training"]["batch_size"], len(get_dataset("train", cfg))
    log("vtacoh", config="configs/VTacOH/VTacOH_YCB.yaml", batch_size=bs,
        train_models=n_train, n_query=cfg["data"]["points_subsample"],
        num_sample=cfg["data"]["num_sample"])
    if bs > n_train:
        raise AssertionError(f"vtacoh: the train split ({n_train}) cannot hold a batch")
    trainer, out, batches = train_stage(
        "vtacoh", cfg, ("encoder", "encoder_hand", "encoder_img", "decoder"))
    if "loaded pretrained t2d" in out or "Validation metric (iou)" not in out:
        raise AssertionError("vtacoh: the loop grafted a t2d stack or validated no IoU")
    wall, busy, launches_per_step, top = profile_steps(trainer, batches[:TRAIN_PROFILED])
    log("vtacoh", profiled_steps=TRAIN_PROFILED, wall_s=wall, kernel_s=busy,
        device_busy_share=busy / wall, kernel_launches_per_step=launches_per_step)
    for name, ms, count in top:
        print(f"[vtacoh] kernel ms_per_step={ms:.3f} launches_per_step={count} {name}")
    t0 = time.perf_counter()
    val = trainer.evaluate(BatchLoader(get_dataset("val", cfg, return_idx=True), 1,
                                       shuffle=False, num_workers=2))
    torch.cuda.synchronize()
    log("vtacoh", validation_s=time.perf_counter() - t0,
        **{f"val_{k}": v for k, v in val.items()})
    if not np.isfinite(val["iou"]):
        raise AssertionError(f"vtacoh: validation IoU {val}")
    return cfg, os.path.abspath(os.path.join(cfg["training"]["out_dir"], "model.ckpt"))


@contextlib.contextmanager
def timed_methods(cls, names, sync=True):
    """Wall time of every call of ``cls``'s methods ``names`` (synchronized
    at its end unless ``sync`` is false: host work that must not wait for
    the card), collected in the yielded {name: [seconds]}."""
    times = {n: [] for n in names}
    orig = {n: getattr(cls, n) for n in names}

    def timed(n):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = orig[n](*args, **kw)
            if sync:
                torch.cuda.synchronize()
            times[n].append(time.perf_counter() - t0)
            return out
        return call

    for n in names:
        setattr(cls, n, timed(n))
    try:
        yield times
    finally:
        for n in names:
            setattr(cls, n, orig[n])


def cli_generate(root, cfg, ckpt, run, *extra):
    """python -m vtaco_tpu_torch.cli.generate on cfg's test split (or as
    ``extra`` arguments say) from ``ckpt``: (the last JSON line, what it
    wrote, the seconds it took)."""
    path = os.path.join(root, f"{run}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    out_dir = os.path.join(root, run)
    t0 = time.perf_counter()
    _, out = printed(generate_cli.main,
                     [path, "--checkpoint", ckpt, "--out-dir", out_dir, *extra])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return json.loads(out.strip().splitlines()[-1]), sorted(os.listdir(out_dir)), seconds


def read_ply_points(path):
    """The (N, 3) points of an ASCII PLY written by meshio.write_ply."""
    with open(path) as f:
        header = [next(f).strip() for _ in range(8)]
    n = int(header[3].split()[-1])
    pts = np.loadtxt(path, skiprows=8, ndmin=2)
    if header[-1] != "end_header" or pts.shape != (n, 3):
        raise AssertionError(f"{path}: malformed PLY")
    return pts


def generate_meshes(root, cfg_ckpt, config, run, kernel, *extra):
    """cli.generate on a config's test split from a checkpoint at nx =
    128 (``extra``: more CLI arguments): its JSON line, an object and a
    hand mesh per object, ``kernel`` (read_counters' name) launched once
    per object and nothing else (counters zeroed just before, read just
    after), each object's mesh and hand-mesh time. Returns the launches."""
    from vtaco_tpu_torch.generate.generator import Generator3D

    cfg, ckpt = cfg_ckpt
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)
    K.fused_trunk_cn.launches_cimg = K.fused_trunk_window_cn.launches_cimg = 0
    with timed_methods(Generator3D, ("generate_obj_mesh_wnf", "generate_hand_mesh")) as t, \
            timed_methods(type(native.mc), ("marching_cubes",), sync=False) as mc:
        line, files, seconds = cli_generate(root, cfg, ckpt, run, *extra)
    launches = read_counters()
    n = line["n"]
    mesh_s, hand_s = t["generate_obj_mesh_wnf"], t["generate_hand_mesh"]
    per_object = [a + b for a, b in zip(mesh_s, hand_s)]
    log("generate", config=config, nx=128, cli_s=seconds,
        object_s_median=float(np.median(per_object)), object_s_each=per_object,
        mesh_s_each=mesh_s, hand_mesh_s_each=hand_s,
        marching_cubes_s_each=mc["marching_cubes"], **line,
        **{f"launches_{k}": v for k, v in launches.items()})
    if not (n >= 1 and np.isfinite(line["cd_mean"]) and np.isfinite(line["emd_mean"])):
        raise AssertionError(f"generate: bad result line {line}")
    for part in ("_obj.off", "_hand.off"):
        got = [f for f in files if f.endswith(part)]
        if len(got) != n:
            raise AssertionError(f"generate: {len(got)} {part} files for {n} objects")
        for f in got:
            verts, faces = meshio.read_off(os.path.join(root, run, f))
            if len(faces) == 0 or not np.isfinite(verts).all():
                raise AssertionError(f"generate: bad mesh {f}")
    if launches[kernel] != n or sum(launches.values()) != n or len(per_object) != n:
        raise AssertionError(f"generate: {config} launched {launches} for {n} objects")
    return launches


def generate_stage(root, vt, tac, vh):
    """(d) cli.generate on the first object of VTacO_YCB's test split from
    (b)'s checkpoint (K1 once per object) and of VTacOH_YCB's from (c)'s
    (K2 on fingertip rows once per object): one object each, since a mesh
    costs about 7 s of the host's EMD; (e) on the tactile config from
    (a)'s checkpoint: one cloud of 5 H W points per sample. Returns the
    launches of both mesh paths."""
    launches = generate_meshes(root, vt, "configs/VTacO/VTacO_YCB.yaml", "generate_vtaco",
                               "fused_trunk_gated_cn", "--max-samples", "1")
    vh_launches = generate_meshes(root, vh, "configs/VTacOH/VTacOH_YCB.yaml",
                                  "generate_vtacoh", "fused_trunk_cn:c_img",
                                  "--max-samples", "1")
    tac_cfg, tac_ckpt = tac
    line, files, seconds = cli_generate(root, tac_cfg, tac_ckpt, "generate_tactile")
    n_pts = [len(read_ply_points(os.path.join(root, "generate_tactile", f))) for f in files]
    log("generate", config="configs/tactile/tactile_test.yaml", cli_s=seconds,
        points_each=n_pts, **line)
    if line["n"] < 1 or len(files) != line["n"] or set(n_pts) != {5 * np.prod(PIPELINE_IMG)}:
        raise AssertionError(f"generate: tactile clouds {files} of {n_pts} points")
    return launches, vh_launches


def visualize_stage(root, vt, tac, vh):
    """(f) LoopGenerator.visualize called directly (not through the loop,
    whose guard would catch its failure) on each checkpoint's model in
    train mode, as the loop hands it over: the validation split's meshes
    (VTacO, VTacOH: every sample of the split cut to its first, a mesh
    costing about 7 s of the host's EMD) or clouds (tactile: every
    vis_split-th)."""
    for phase, (cfg, ckpt), want in (("vtaco", vt, ("_obj.off", "_hand.off")),
                                     ("vtacoh", vh, ("_obj.off", "_hand.off")),
                                     ("tactile", tac, ("_tactile.ply",))):
        model = get_model(cfg)
        CheckpointIO(cfg["training"]["out_dir"], model=model).load(ckpt)
        model.train()
        ds = get_dataset("val", cfg, return_idx=True)
        if phase != "tactile":
            ds.models = ds.models[:1]
        out_dir = os.path.join(root, f"visualize_{phase}")
        t0 = time.perf_counter()
        _, out = printed(make_loop_generator(model, cfg).visualize, model,
                         BatchLoader(ds, 1, shuffle=False, num_workers=1), out_dir, 7)
        seconds = time.perf_counter() - t0
        files = sorted(os.listdir(os.path.join(out_dir, "vis")))
        g = cfg["generation"]
        n = len(ds) if g["vis_all"] else len(range(0, len(ds), g["vis_split"]))
        log("visualize", config=phase, seconds=seconds, samples=n, files=files)
        if (not model.training or len(files) != n * len(want)
                or not all(f.startswith("7_") for f in files)
                or sorted(f[-len(w):] for f in files for w in want if f.endswith(w))
                != sorted(want * n)):
            raise AssertionError(f"visualize: {phase} wrote {files} for {n} samples")
        if phase != "tactile" and "Metrics CD:" not in out:
            raise AssertionError("visualize: no metrics printed")


# ---------------------------------------------------------------------------
# the fast phase: the *_fast configs

def crop_inputs(batch, dev):
    """A crop batch's encoder input: {"points", "index": {plane: (B, N)}}."""
    return {"points": torch.as_tensor(batch["inputs"], device=dev),
            "index": {k.split(".")[-1]: torch.as_tensor(v[:, 0], dtype=torch.int64,
                                                         device=dev)
                      for k, v in batch.items() if k.startswith("inputs.ind.")}}


def crop_stage(root, data):
    """(i) scene_crop (configs/crop/scene_crop.yaml) at its shipped full
    width through python -m vtaco_tpu_torch.cli.train (its main) for
    CROP_ITERS steps, then its warm steps at each precision, one 'highest'
    step against the CPU's float32 step, and Generator3D.eval_points on
    CROP_EVAL_N points of the scene from the checkpoint (the whole scene's
    88² planes; the chunked module decode), the card against the CPU on
    CROP_CPU_N of them. Every counter is zeroed before the CLI and before
    eval_points and read after the CPU step and after eval_points: the
    crop path reaches no kernel (as in the JAX package)."""
    from vtaco_tpu_torch.cli import train as train_cli

    path = os.path.join(REPO, "configs/crop/scene_crop.yaml")
    out_dir = os.path.join(root, "crop")
    zero_counters()
    t0 = time.perf_counter()
    printed(train_cli.main, [path, "--data-root", data[0], "--max-iters", str(CROP_ITERS),
                             "--out-dir", out_dir])
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    ckpt = os.path.join(out_dir, "model.ckpt")
    if CheckpointIO(out_dir).load_raw("model.ckpt")[1]["it"] != CROP_ITERS:
        raise AssertionError("crop: cli.train wrote no checkpoint at its last step")
    cfg = load_config(path, os.path.join(REPO, "configs/default.yaml"))
    cfg["data"]["path"] = data[0]
    cfg["training"]["out_dir"] = out_dir
    train_ds = get_dataset("train", cfg)
    model = get_model(cfg, dataset=train_ds)
    CheckpointIO(out_dir, model=model).load(ckpt)
    enc = model.encoder
    log("crop", config="configs/crop/scene_crop.yaml", cli_iters=CROP_ITERS, loop_s=loop_s,
        params=sum(p.numel() for p in model.parameters()),
        plane_resolution=enc.plane_resolution, planes=list(enc.planes),
        batch_size=cfg["training"]["batch_size"], pointcloud_n=cfg["data"]["pointcloud_n"],
        points_subsample=cfg["data"]["points_subsample"])

    trainer = Trainer.from_config(model, cfg)
    loader = BatchLoader(train_ds, cfg["training"]["batch_size"], num_workers=4, seed=1)
    n_steps = (TRAIN_WARM + TRAIN_TIMED) * len(TRAIN_PRECISIONS)
    batches = take(loader, n_steps + 1)
    torch.cuda.reset_peak_memory_stats()
    runs, scalars = timed_steps(trainer, batches[:n_steps])
    log("crop", peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30, **scalars)
    for prec, (times, _) in runs.items():
        log("crop", matmul_precision=prec, step_s=float(np.median(times)),
            step_s_min=min(times), step_s_max=max(times))
    rel, cos, ratio, cpu_s = step_against_cpu(cfg, trainer, batches[-1], torch.float32,
                                              dataset=train_ds)
    log("crop", vs_cpu="loss_rel_err", cpu_dtype="float32", cpu_step_s=cpu_s, **rel)
    log("crop", vs_cpu="grad_cosine", **cos)
    log("crop", vs_cpu="grad_norm_ratio", **ratio)
    if max(rel.values()) > TRAIN_RTOL or min(cos.values()) < GRAD_COS:
        raise AssertionError(f"crop: card step differs from the CPU step: {rel} {cos}")
    if set(cos) != {"encoder", "decoder"}:
        raise AssertionError(f"crop: modules with gradients: {sorted(cos)}")
    train_launches = read_counters()
    del trainer, batches

    # the whole scene, decoded from the checkpoint
    test_ds = get_dataset("test", cfg, return_idx=True)
    models = {}
    for dev_name in ("cuda", "cpu"):
        m = get_model(cfg, device=dev_name, dataset=test_ds)
        CheckpointIO(out_dir, model=m).load(ckpt)
        models[dev_name] = m.eval()
    np.random.seed(0)
    batch = next(iter(BatchLoader(test_ds, 1, shuffle=False, num_workers=1)))
    pts = np.random.default_rng(8).uniform(-0.55, 0.55, (CROP_EVAL_N, 3)).astype(np.float32)
    gens = {d: get_generator(m, cfg) for d, m in models.items()}
    with torch.no_grad():
        c = {d: m.encode_inputs(crop_inputs(batch, d)) for d, m in models.items()}
    zero_counters()
    times = []
    for _ in range(1 + 3):                 # one cold call, three warm
        t0 = time.perf_counter()
        got = gens["cuda"].eval_points(models["cuda"], pts, c["cuda"],
                                       transfer_dtype=torch.float32)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    eval_launches = read_counters()
    t0 = time.perf_counter()
    want = gens["cpu"].eval_points(models["cpu"], pts[:CROP_CPU_N], c["cpu"],
                                   transfer_dtype=torch.float32)
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(got[:CROP_CPU_N] - want).max())
    log("crop", eval_points_n=CROP_EVAL_N, chunk=gens["cuda"].points_batch_size,
        plane_resolution=models["cuda"].encoder.plane_resolution,
        call_s=float(np.median(times[1:])), call_s_each=times[1:], first_call_s=times[0],
        vs_cpu_n=CROP_CPU_N, vs_cpu_max_abs_err=err, cpu_call_s=cpu_s,
        logit_min=float(got.min()), logit_max=float(got.max()))
    if not (err <= ATOL and np.isfinite(got).all()):
        raise AssertionError(f"crop: eval_points on the card differs from the CPU: {err}")
    launched = {k: v for k, v in list(train_launches.items()) + list(eval_launches.items())
                if v}
    log("crop", kernel_launches=sum(launched.values()))
    if launched:
        raise AssertionError(f"crop: the crop path launched kernels: {launched}")


def fast_config(name, path, root, data, t2d_ckpt):
    """A *_fast config on the pipeline's set, validated and checkpointed
    every K + 2 steps; VTacO grafts the tactile stage's stack."""
    cfg = pipeline_config(path, root, data, f"fast_{name}")
    k = int(cfg["training"]["steps_per_dispatch"])
    cfg["training"].update(validate_every=k + 2, checkpoint_every=k + 2)
    if name == "vtaco":
        cfg["model"]["encoder_t2d_kwargs"]["model_file"] = t2d_ckpt
    if name != "tactile":
        cfg["generation"]["mc_level"] = "mean"
    return cfg, k


def logged_blocks(out_dir):
    """The fused loop's block lengths, in order, from its metrics log."""
    with open(os.path.join(out_dir, "logs", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [int(r["value"]) for r in recs if r["tag"] == "train/steps_per_block"]


def fast_loop(phase, cfg, k):
    """(a) loop.train on the device-resident split: K + 2 steps (blocks of
    K, 1 and 1: validation and a checkpoint at K + 2), then a resume to
    2K + 3 (blocks of K and 1). Returns the resumed run's trainer."""
    first, total = k + 2, 2 * k + 3
    t0 = time.perf_counter()
    (_, it1), out1 = printed(loop.train, cfg, max_iters=first, device="cuda", seed=0,
                             generator_factory=make_loop_generator)
    (trainer, it2), out2 = printed(loop.train, cfg, max_iters=total, device="cuda",
                                   seed=0, generator_factory=make_loop_generator)
    torch.cuda.synchronize()
    out_dir = cfg["training"]["out_dir"]
    sizes = logged_blocks(out_dir)
    with open(os.path.join(out_dir, "logs", "metrics.jsonl")) as f:
        its = [json.loads(line)["it"] for line in f if '"train/loss"' in line]
    resident = re.search(r"device-resident dataset: (\d+) models, ([\d.]+) MB on \S+ "
                         r"\(val: (\d+) models, ([\d.]+) MB\)", out1)
    log(phase, loop_s=time.perf_counter() - t0, iterations=it2, blocks=sizes,
        train_models=resident and int(resident[1]), resident_mb=resident and float(resident[2]),
        val_models=resident and int(resident[3]), val_resident_mb=resident and float(resident[4]))
    if (it1, it2) != (first, total) or sizes != [k, 1, 1, k, 1] or its != list(
            range(1, total + 1)) or resident is None:
        raise AssertionError(f"{phase}: loop ran {it1}, {it2} in blocks {sizes}, logged {its}")
    if f"resumed at it={first}" not in out2 or "Validation metric" not in out1:
        raise AssertionError(f"{phase}: no resume at {first} or no fused validation")
    for f in ("model.ckpt", "model_best.ckpt"):
        if not os.path.exists(os.path.join(out_dir, f)):
            raise AssertionError(f"{phase}: loop.train wrote no {f}")
    if trainer.step != total or trainer.compute_dtype != "bfloat16":
        raise AssertionError(f"{phase}: trainer at step {trainer.step}, {trainer.compute_dtype}")
    bad = [k2 for k2, v in trainer.model.state_dict().items()
           if v.is_floating_point() and v.dtype != torch.float32]
    bad += [k2 for st in trainer.optimizer.state.values() for k2, v in st.items()
            if torch.is_tensor(v) and v.is_floating_point() and v.dtype != torch.float32]
    if bad:
        raise AssertionError(f"{phase}: master state not float32: {bad[:5]}")
    return trainer


def profiled(fn, n_steps):
    """fn() under torch.profiler: (wall seconds, the kernels' device
    seconds, kernel launches per step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    return (wall, sum(e.self_device_time_total for e in kernels) / 1e6,
            sum(e.count for e in kernels) / n_steps)


def fast_timing(phase, cfg, trainer, k):
    """(b) at the config's precision ('default'): the warm time per step in
    a fused block (its wall time, ending in its one host read, over K)
    and, in the same process, the plain float32 step of the same model
    (host loader batches, one train_step each, compute_dtype and
    skip_unused_t2d off as in the non-fast config), FAST_ROUNDS rounds of
    one block and K plain steps, with least and most; the peak memory of
    each; launches per step and busy share under torch.profiler; and the
    host syncs inside a block (utils.profiling.host_syncs around the fused
    call, whose scalars stay on the card until the read after it)."""
    bs = cfg["training"]["batch_size"]
    n_points, n_cloud = cfg["data"]["points_subsample"], cfg["data"]["pointcloud_n"]
    dds = DeviceDataset(get_dataset("train", cfg), device="cuda",
                        pointcloud_noise=cfg["data"]["pointcloud_noise"])
    loader = DeviceBatchLoader(dds, bs, n_points, n_cloud, seed=1)
    fused = trainer.make_fused_train_fn(dds, n_points, n_cloud)

    def block():
        return trainer.read_scalars(fused(loader.take_ids(k), loader.next_key()))

    plain_cfg = copy.deepcopy(cfg)
    plain_cfg["training"].update(compute_dtype=None, skip_unused_t2d=False)
    plain = Trainer.from_config(trainer.model, plain_cfg, mesh_bank=trainer.mesh_bank, seed=1)
    batches = take(BatchLoader(get_dataset("train", cfg), bs, num_workers=4, seed=1),
                   (FAST_ROUNDS + 2) * k)
    block()        # warm-up
    for b in batches[-k:]:
        plain.train_step(b)
    fused_s, plain_s, peak_f, peak_p = [], [], 0, 0
    for r in range(FAST_ROUNDS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        scal = block()
        fused_s.append((time.perf_counter() - t0) / k)
        peak_f = max(peak_f, torch.cuda.max_memory_allocated())
        if not all(np.isfinite(v).all() for v in scal.values()):
            raise AssertionError(f"{phase}: non-finite fused scalars {scal}")
        torch.cuda.reset_peak_memory_stats()
        for b in batches[r * k:(r + 1) * k]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain.train_step(b)
            torch.cuda.synchronize()
            plain_s.append(time.perf_counter() - t0)
        peak_p = max(peak_p, torch.cuda.max_memory_allocated())
    log(phase, matmul_precision=trainer.matmul_precision, batch_size=bs, steps_per_block=k,
        fused_step_s=float(np.median(fused_s)), fused_step_s_min=min(fused_s),
        fused_step_s_max=max(fused_s), fused_step_s_each=fused_s,
        plain_step_s=float(np.median(plain_s)), plain_step_s_min=min(plain_s),
        plain_step_s_max=max(plain_s), fused_peak_mem_gib=peak_f / 2 ** 30,
        plain_peak_mem_gib=peak_p / 2 ** 30)
    wall, busy, launches = profiled(block, k)
    p_wall, p_busy, p_launches = profiled(lambda: [plain.train_step(b) for b in batches[:k]], k)
    log(phase, profiled="fused_block", steps=k, wall_s=wall, kernel_s=busy,
        device_busy_share=busy / wall, kernel_launches_per_step=launches)
    log(phase, profiled="plain_steps", steps=k, wall_s=p_wall, kernel_s=p_busy,
        device_busy_share=p_busy / p_wall, kernel_launches_per_step=p_launches)
    torch.cuda.synchronize()
    stacked, syncs = host_syncs(fused, loader.take_ids(k), loader.next_key())
    scal = trainer.read_scalars(stacked)
    sites = sorted({f"{os.path.relpath(f, REPO)}:{line}" for f, line in syncs})
    log(phase, host_syncs_per_block=len(syncs), final_reads_per_block=1, sync_sites=sites)
    if not all(v.shape == (k,) and np.isfinite(v).all() for v in scal.values()):
        raise AssertionError(f"{phase}: the checked block's scalars: {scal}")


def fast_draws(trainer, a, seed):
    """The decode sample's draws of one step, made once so that every step
    compared takes them: the t2d contact sample's, or the fingertip
    sample's from the model's float32 fingertips."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if trainer.train_tactile:
        return None
    if trainer.encode_t2d:
        H, W = a["imgs"].shape[2:4]
        return C.contact_draws(a["depths"], a["touch_success"],
                               trainer._depth_origin_for(H * W), a["points"].shape[1],
                               trainer.num_sample, trainer.contact_per_finger, g)
    with torch.no_grad():
        joints = trainer.model.encode_hand_inputs(a["inputs"])["mano_joints"]
    tips = C.tips_in_object_frame(joints, a["mano"][:, :3], a["wrist"], a["pc_ply"])
    return C.tips_draws(C.tips_mask(a["points"], tips, a["touch_success"]),
                        trainer.num_sample, trainer.tips_per_finger, g)


def step_grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def module_rel(grads, ref):
    """Each top-level module's gradient distance to ``ref`` relative to
    ref's norm, over ref's tensors less exact_zero's."""
    live = set(ref) - exact_zero(ref)
    out = {}
    for mod in sorted({n.split(".")[0] for n in live}):
        names = [n for n in live if n.split(".")[0] == mod]
        g = torch.cat([grads[n].flatten().double() for n in names])
        w = torch.cat([ref[n].flatten().double() for n in names])
        if float(w.norm()) > 0:
            out[mod] = float((g - w).norm() / w.norm())
    return out


def fast_precision(phase, name, cfg, trainer, state, hold):
    """(c) one bfloat16 step (the config's keep_f32_modules) against the
    card's float32 'highest' step from the weights ``state``, a host loader
    batch from seed 5 and one set of draws: the loss scalars' relative
    gaps and each module's relative gradient distance, within
    step_bars(name) when ``hold``; forward hooks must see the encoders'
    outputs in bfloat16 and the decoder's inputs in float32. The model's
    own state is put back. Returns the prepared batch and the draws."""
    model = trainer.model
    own = {k: v.detach().clone() for k, v in model.state_dict().items()}
    bs = cfg["training"]["batch_size"]
    np.random.seed(5)   # the items' subsampling and noise draw from it
    batch = next(iter(BatchLoader(get_dataset("train", cfg), bs, num_workers=1, seed=5)))
    model.load_state_dict(state)
    a = trainer.prepare_batch(batch)
    draws = fast_draws(trainer, a, 6)
    seen = {}

    def hook(name, inputs):
        def record(mod, args, out):
            x = args if inputs else out
            vals = x.values() if isinstance(x, dict) else (x if isinstance(x, tuple) else (x,))
            seen.setdefault(name, set()).update(
                str(v.dtype)[6:] for v in vals if torch.is_tensor(v) and v.is_floating_point())
        return record

    watched = {"encoder": False, "encoder_hand": False, "encoder_img": False}
    handles = [getattr(model, m).register_forward_hook(hook(m, inp))
               for m, inp in watched.items() if getattr(model, m) is not None]
    if model.decoder is not None:
        handles += [model.decoder.fc_p_img.register_forward_hook(hook("decoder", True)),
                    model.decoder.fc_out.register_forward_hook(hook("decoder_out", False))]
    runs = {}
    try:
        for dt in ("bfloat16", None):
            seen.clear()
            model.load_state_dict(state)
            tr = Trainer.from_config(model, cfg, mesh_bank=trainer.mesh_bank, seed=2,
                                     compute_dtype=dt, matmul_precision="highest")
            runs[dt] = tr.train_step(batch, draws), step_grads(model), dict(seen)
    finally:
        for h in handles:
            h.remove()
    model.load_state_dict(own)
    (s16, g16, seen16), (s32, g32, seen32) = runs["bfloat16"], runs[None]
    rel = {k: abs(s16[k] - s32[k]) / max(abs(s32[k]), 1e-12) for k in s32}
    dist = module_rel(g16, g32)
    loss_bar, grad_bars = step_bars(name)
    weights = "seed0" if hold else "trained"
    log(phase, weights=weights, vs_float32_highest="loss_rel_gap", bar=loss_bar, held=hold,
        **({} if hold else {"jax_full_width_bars": trained_bars(name)}), **rel)
    log(phase, weights=weights, vs_float32_highest="grad_rel_dist", bars=grad_bars, held=hold,
        **dist)
    log(phase, weights=weights, dtypes_bf16_step=seen16, dtypes_f32_step=seen32)
    want16 = {m: {"bfloat16"} for m in watched if getattr(model, m) is not None}
    if model.decoder is not None:
        want16.update(decoder={"float32"}, decoder_out={"float32"})
    if seen16 != want16 or any(v != {"float32"} for v in seen32.values()):
        raise AssertionError(f"{phase}: the modules ran in {seen16} (want {want16})")
    if hold and (max(rel.values()) > loss_bar or set(dist) != set(grad_bars)
                 or any(d > grad_bars[m] for m, d in dist.items())):
        raise AssertionError(f"{phase}: bfloat16 step beyond its bars: {rel} {dist}")
    return a, draws


def module_eval(model, cfg, mod, x, cot, dtype, fault=None):
    """``mod`` alone as a bfloat16 step runs it (Trainer._call on the cast
    parameters; train mode, the BatchNorm statistics left alone) on x, at
    'highest', with the cotangent ``cot`` on its floating outputs (None:
    drawn from seed 5 on the CPU): ({output: tensor}, {parameter:
    gradient}, cot), in float64 on the CPU. ``fault``: 'float32' keeps the
    module in float32, 'bf16_batchnorm' plants that BatchNorm. On the CPU
    oneDNN stays on (Trainer turns it off for bfloat16 steps because of a
    fault on 1x1 inputs, which full-size images never reach; without it a
    bfloat16 64^3 UNet3D takes minutes)."""
    keep = ("decoder", mod) if fault == "float32" else ("decoder",)
    tr = Trainer.from_config(model, cfg, compute_dtype=dtype, keep_f32_modules=keep,
                             matmul_precision="highest")
    model.train()
    model.zero_grad(set_to_none=True)
    method = MODULE_METHODS[mod][0]
    forward = BatchNorm2d.forward
    if fault == "bf16_batchnorm":
        BatchNorm2d.forward = bf16_batchnorm
    try:
        with frozen_batch_stats(), matmul_precision("highest"):
            if dtype is not None:
                tr._params = tr._module_params(tr._cast_params(dict(model.named_parameters())))
            out = tr._call(method, x)
            out = {k: v for k, v in (sorted(out.items()) if isinstance(out, dict)
                                     else [("out", out)]) if v.is_floating_point()}
            if cot is None:
                g = torch.Generator().manual_seed(5)
                cot = {k: torch.randn(v.shape, generator=g) for k, v in out.items()}
            torch.autograd.backward([out[k] for k in cot],
                                    [cot[k].to(out[k].device, out[k].dtype) for k in cot])
    finally:
        tr._params = None
        BatchNorm2d.forward = forward
    grads = {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()
             if n.split(".")[0] == mod and p.grad is not None}
    model.zero_grad(set_to_none=True)
    return {k: v.detach().double().cpu() for k, v in out.items()}, grads, cot


@contextlib.contextmanager
def deterministic():
    """torch.use_deterministic_algorithms for the block (cuDNN's choice
    too); yields the list that collects the names of the operations that
    warned that they have no deterministic kernel."""
    cudnn = torch.backends.cudnn.deterministic
    ops = []
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield ops
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = cudnn
            ops += sorted({str(w.message).split(" does not have a deterministic")[0]
                           for w in seen if "does not have a deterministic" in str(w.message)})


def fast_modules(phase, name, cfg, trainer, state, a):
    """(c) each module of FAST_MODULES alone at the weights ``state`` (the
    built ones: the trained weights differ from run to run), on the first
    sample of (c)'s batch, under deterministic() so that a run reads what
    the last one did: the card's bfloat16 evaluation against the port's
    bfloat16 evaluation on the host CPU (held to the JAX
    package's on the CPU by tests/test_torch_fast_modules.py), R = the
    distance in units of the CPU's bfloat16-to-float32 gap (the card's
    float32 'highest' evaluation standing for float32), per output and
    for the gradient, within CARD_BAR (the hand encoders' outputs logged
    only: tests/bf16_checks.py); each planted fault on the card (the
    module in float32; BatchNorm in bfloat16 where the module has
    BatchNorm) logged beside it, with whether it exceeds the bar (the CPU
    test holds that it does)."""
    model = trainer.model
    own = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model.load_state_dict(state)
    cpu_model = copy.deepcopy(model).cpu()
    failed = {}
    with deterministic() as ops:
        R_all = {mod: module_ratios(model, cpu_model, cfg, mod, a)
                 for mod in FAST_MODULES[name]}
    model.load_state_dict(own)
    for mod, (R, cpu_s) in R_all.items():
        held = ("grad",) if mod in CARD_OUTPUTS_LOGGED else tuple(R["port"])

        def exceeds(r):
            return any(r[k] > CARD_BAR for k in held)

        log(phase, module=mod, cpu_reference_s=cpu_s, bar=CARD_BAR, held=held,
            **{f"R_{t}": v for t, v in R.items()},
            **{f"{t}_exceeds": exceeds(v) for t, v in R.items() if t != "port"})
        if exceeds(R["port"]):
            failed[mod] = R["port"]
    log(phase, modules_nondeterministic_ops=ops)
    if failed:
        raise AssertionError(f"{phase}: modules against the CPU's bfloat16: {failed}")


def module_ratios(model, cpu_model, cfg, mod, a):
    """fast_modules' readings of one module: ({'port' and each fault: R},
    the CPU reference's seconds)."""
    x = a[MODULE_METHODS[mod][1]][:1]
    f32 = module_eval(model, cfg, mod, x, None, None)
    cot = f32[2]
    t0 = time.perf_counter()
    ref16 = module_eval(cpu_model, cfg, mod, x.cpu().bfloat16(), cot, "bfloat16")
    cpu_s = time.perf_counter() - t0
    has_bn = any(isinstance(m, BatchNorm2d) for m in getattr(model, mod).modules())
    runs = {"port": module_eval(model, cfg, mod, x.bfloat16(), cot, "bfloat16"),
            "fault_float32": module_eval(model, cfg, mod, x.bfloat16(), cot, "bfloat16",
                                         "float32")}
    if has_bn:
        runs["fault_bf16_batchnorm"] = module_eval(model, cfg, mod, x.bfloat16(), cot,
                                                   "bfloat16", "bf16_batchnorm")
    live = sorted(set(f32[1]) - exact_zero(f32[1]))

    def ratio(got):
        r = {k: float((got[0][k] - ref16[0][k]).norm() / (ref16[0][k] - f32[0][k]).norm())
             for k in f32[0]}
        num = sum(float((got[1][n] - ref16[1][n]).norm() ** 2) for n in live)
        den = sum(float((ref16[1][n] - f32[1][n]).norm() ** 2) for n in live)
        r["grad"] = float(np.sqrt(num / den))
        return r

    return {tag: ratio(v) for tag, v in runs.items()}, cpu_s


def fast_remat(phase, cfg, trainer, a, draws):
    """(d) from the trained weights, with (c)'s batch and draws, in the
    config's precision: FAST_PLAIN plain steps and a rematerialized one
    (training.remat), first as the card runs them (the spread between
    plain steps that its atomics make), then under deterministic() (its
    warnings name the operations that have no deterministic kernel: there
    plain steps mostly agree bit for bit). Held: the deterministic remat
    step's loss scalars and each module's gradient no farther from the
    nearest plain step than two plain steps of either run are from each
    other (or 1e-6); its BatchNorm buffers equal a plain step's (the
    recomputation moves nothing). The peak memory of each."""
    model = trainer.model
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def step(remat):
        model.load_state_dict(state)
        tr = Trainer.from_config(model, cfg, mesh_bank=trainer.mesh_bank, seed=3, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sc = tr._host(tr._train_step(a, draws))
        peak = torch.cuda.max_memory_allocated()
        bufs = {k: v.detach().clone() for k, v in model.state_dict().items()
                if "running" in k or "num_batches" in k}
        return sc, step_grads(model), bufs, peak

    def dist(x, y):
        d = {k: abs(x[0][k] - y[0][k]) / max(abs(y[0][k]), 1e-12) for k in y[0]}
        for mod in {n.split(".")[0] for n in y[1]}:
            names = [n for n in y[1] if n.split(".")[0] == mod]
            g = torch.cat([x[1][n].flatten().double() for n in names])
            w = torch.cat([y[1][n].flatten().double() for n in names])
            d[mod] = float((g - w).norm() / w.norm())
        return d

    def compare(plain, remat):
        spread, got = {}, {}
        for i in range(FAST_PLAIN):
            for k, v in dist(remat, plain[i]).items():
                got[k] = min(got.get(k, np.inf), v)
            for j in range(i + 1, FAST_PLAIN):
                for k, v in dist(plain[i], plain[j]).items():
                    spread[k] = max(spread.get(k, 0.0), v)
        return spread, got

    spread, got = compare([step(False) for _ in range(FAST_PLAIN)], step(True))
    log(phase, remat="plain_spread", deterministic=False, **spread)
    log(phase, remat="remat_to_nearest_plain", deterministic=False, **got)
    with deterministic() as ops:
        plain = [step(False) for _ in range(FAST_PLAIN)]
        remat = step(True)
    model.load_state_dict(state)
    det_spread, det_got = compare(plain, remat)
    log(phase, remat="plain_spread", deterministic=True, **det_spread)
    log(phase, remat="remat_to_nearest_plain", deterministic=True, **det_got)
    log(phase, remat_nondeterministic_ops=ops)
    buf_equal = all(torch.equal(remat[2][k], v) for k, v in plain[0][2].items())
    log(phase, remat_peak_mem_gib=remat[3] / 2 ** 30, plain_peak_mem_gib=plain[0][3] / 2 ** 30,
        batchnorm_buffers=len(plain[0][2]), batchnorm_buffers_equal=buf_equal)
    far = {k: v for k, v in det_got.items()
           if v > max(spread[k], det_spread[k], 1e-6)}
    if far or not buf_equal or not plain[0][2]:
        raise AssertionError(f"{phase}: remat step differs: {far}, buffers equal {buf_equal}")


def group_norm_bf16_check():
    """GroupNorm on a bfloat16 input on the card (UNet3D's first norm at
    VTacO_YCB's batch of 3 and 64^3 x 32 grid) against the float32
    evaluation of the same input and weights, in bfloat16 ulps of each
    output: torch's own kernel (logged: it rounds on the way) and the
    port's models.unet3d.GroupNorm, which must be within one, as flax
    reduces and normalizes in float32 and rounds once."""
    from vtaco_tpu_torch.models.unet3d import GroupNorm

    g = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn((3, 32, 64, 64, 64), generator=g, device="cuda") * 3 + 1).bfloat16()
    norm = GroupNorm(8, 32).cuda()
    with torch.no_grad():
        norm.weight.copy_(torch.rand(32, generator=g, device="cuda") + 0.5)
        norm.bias.copy_(torch.randn(32, generator=g, device="cuda"))
        w, b = norm.weight.bfloat16(), norm.bias.bfloat16()
        want = torch.nn.functional.group_norm(x.float(), 8, w.float(), b.float(), 1e-5)

        def ulps(got):
            return float(((got.float() - want).abs()
                          / (want.abs() * 2.0 ** -8).clamp_min(1e-30)).max())

        torch_ulps = ulps(torch.nn.functional.group_norm(x, 8, w, b, 1e-5))
        norm.weight.copy_(w.float())
        norm.bias.copy_(b.float())
        port_ulps = ulps(norm(x))
    log("fast", group_norm_bf16_torch_max_ulps=torch_ulps,
        group_norm_bf16_port_max_ulps=port_ulps)
    if port_ulps > 1.0:
        raise AssertionError(f"fast: the port's bfloat16 GroupNorm is {port_ulps} ulps off")


def fast_phase(root, data, t2d_ckpt):
    """(g) the three *_fast configs at full width on the pipeline's set:
    (a) the loop in fused blocks with validation, checkpoints and a
    resume, (b) their steps' time, memory, launches and syncs beside the
    plain step's, (c) the bfloat16 step against the float32 one, (d)
    remat against plain, (e) cli.generate from the VTacO and VTacOH
    checkpoints on one object each (K1, and K2 on fingertip rows). Returns
    (e)'s launches by path."""
    group_norm_bf16_check()
    launches = {}
    for name, path in FAST_CONFIGS:
        phase = f"fast_{name}"
        cfg, k = fast_config(name, path, root, data, t2d_ckpt)
        log(phase, config=path, steps_per_dispatch=k, compute_dtype=cfg["training"]["compute_dtype"],
            on_device=cfg["data"]["on_device"], batch_size=cfg["training"]["batch_size"])
        trainer = fast_loop(phase, cfg, k)
        fast_timing(phase, cfg, trainer, k)
        trained = {k2: v.detach().clone() for k2, v in trainer.model.state_dict().items()}
        torch.manual_seed(0)
        built = get_model(cfg, device="cpu").state_dict()
        fast_precision(phase, name, cfg, trainer, built, hold=True)
        a, draws = fast_precision(phase, name, cfg, trainer, trained, hold=False)
        fast_modules(phase, name, cfg, trainer, built, a)
        fast_remat(phase, cfg, trainer, a, draws)
        ckpt = os.path.abspath(os.path.join(cfg["training"]["out_dir"], "model.ckpt"))
        del trainer, a, draws
        torch.cuda.empty_cache()
        if name == "vtaco":
            launches["fast_cli_generate"] = generate_meshes(
                root, (cfg, ckpt), path, "fast_generate_vtaco", "fused_trunk_gated_cn",
                "--max-samples", "1")
        elif name == "vtacoh":
            launches["fast_vtacoh_cli_generate"] = generate_meshes(
                root, (cfg, ckpt), path, "fast_generate_vtacoh", "fused_trunk_cn:c_img",
                "--max-samples", "1")
    return launches


# ---------------------------------------------------------------------------
# the host engines and generation.matmul_precision (F7)

def canon(verts, faces):
    """A mesh as its sorted triangle soup (vertex order aside), to 1e-5."""
    tri = verts[faces].reshape(len(faces), -1)
    return np.round(tri[np.lexsort(tri.T[::-1])], 5)


def bumpy_field(n):
    """An n^3 float32 field whose 0 level is a bumpy ellipsoid spanning
    most of the box."""
    x = np.linspace(-1, 1, n, dtype=np.float32)
    X, Y, Z = x[:, None, None], x[None, :, None], x[None, None, :]
    r = np.sqrt(X ** 2 / 0.8 + Y ** 2 + Z ** 2 / 0.6)
    return (0.8 - r + 0.05 * np.sin(7 * X) * np.sin(5 * Y) * np.sin(3 * Z)).astype(np.float32)


def host_call(fn, *args):
    """(fn's result, its seconds on the host clock) of one call."""
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def init_phase(dev):
    """Fresh models drawn on the card as the JAX package's init draws them
    (tests/port_checks.py)."""
    t0 = time.perf_counter()
    total, worst = 0, (0.0, None)
    for seed, (name, path) in enumerate(INIT_CONFIGS):
        t1 = time.perf_counter()
        cfg = load_config(path, "configs/default.yaml")
        model = get_model(cfg, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(100 + seed))
        r = check_fresh_model(model)
        torch.cuda.synchronize()
        log("init", config=name, tensors=r["tensors"], exact=r["exact"], drawn=r["drawn"],
            worst_z=r["worst_z"], worst=r["worst"], failures=len(r["failures"]),
            seconds=time.perf_counter() - t1)
        if r["failures"]:
            raise AssertionError(f"{name}: drawn off its initializer: {r['failures'][:5]}")
        total += r["tensors"]
        worst = max(worst, (r["worst_z"], f"{name}:{r['worst']}"))
        del model
    log("init", tensors=total, worst_z=worst[0], worst=worst[1], z_bar=5.0,
        seconds=time.perf_counter() - t0)


def helpers_phase(dev):
    """The geometry and metric helpers on card tensors against the CPU."""
    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(31)

    def both(fn, *args):
        """fn on the CPU tensors and on their copies on the card."""
        return fn(*args), fn(*(a.to(dev) for a in args)).cpu()

    cam = G.Camera(width=240, height=320, near_plane=0.019, far_plane=0.022, fov=60)
    depth = 0.019 + 0.0032 * torch.rand((320, 240), generator=g)
    pts = torch.rand((2, 4096, 3), generator=g) * 1.1 - 0.55
    rot = G.quat2mat(torch.randn((2, 4), generator=g))
    rt = torch.cat([rot, 0.1 * torch.randn((2, 3, 1), generator=g)], dim=2)
    k = torch.tensor([[1.2, 0.0, 0.1], [0.0, 1.2, 0.1], [0.0, 0.0, 1.0]]).expand(2, 3, 3)
    front = pts + torch.tensor([0.0, 0.0, 2.0])
    q = G.quaternion_normalize(torch.randn((4096, 4), generator=g))
    r = G.quaternion_normalize(torch.randn((4096, 4), generator=g))
    mats = spread_matrices(g, 1024)
    errs = {}
    cloud = both(cam.depth_to_camera_pointcloud, depth)
    masks = (cam.valid_mask(cloud[0]), cam.valid_mask(cloud[1]))
    for name, (want, got) in {
            "camera": cloud, "transform_rt": both(G.transform_points, pts, rt),
            "transform_k": both(G.transform_points, pts, k),
            "project": both(G.project_to_camera, front, k),
            "quaternion_mul": both(G.quaternion_mul, q, r),
            "quaternion_inv": both(G.quaternion_inv, q),
            "quaternion_normalize": both(G.quaternion_normalize, 2 * q),
            "quaternion_to_rotation_matrix": both(G.quaternion_to_rotation_matrix, q),
            "rotmat_projection": both(G.rotmat_projection, mats)}.items():
        errs[name] = float((got - want).abs().max())
    joints = torch.randn((2, 1, 21, 3), generator=g, dtype=torch.float64)
    joint_err = (metrics.hand_joint_error(*joints),
                 metrics.hand_joint_error(*(j.to(dev) for j in joints)))
    log("helpers", **{f"{k}_err": v for k, v in errs.items()},
        masks_equal=bool(torch.equal(*masks)), valid=int(masks[0].sum()),
        hand_joint_error=joint_err[0], hand_joint_error_card=joint_err[1],
        tol=HELPERS_TOL, rotmat_tol=ROTMAT_TOL, seconds=time.perf_counter() - t0)
    bad = {k: v for k, v in errs.items()
           if v > (ROTMAT_TOL if k == "rotmat_projection" else HELPERS_TOL)}
    if bad or not torch.equal(*masks) or joint_err[0] != joint_err[1]:
        raise AssertionError(f"a helper on the card disagrees with the CPU: {bad}, "
                             f"masks equal {torch.equal(*masks)}, {joint_err}")


def host_engines_phase():
    """The native host engines on the card's host, against their plain
    references: marching cubes at 129^3 against _marching_cubes_numpy
    (the same triangle soup, both times), the x-slab threads at 513^3
    against one thread (equal vertex counts, the same soup), and the
    lattice encode of the shuffled 128^3 lattice against its numpy form
    (the same nodes)."""
    native.mc._ensure()
    native.geom._ensure()
    vol = bumpy_field(LATTICE_NX + 1)
    (vn, fn), numpy_s = host_call(_marching_cubes_numpy, vol, 0.0)
    (vc, fc), native_s = host_call(native.mc.marching_cubes, vol, 0.0)
    (v1, f1), one_s = host_call(native.mc.marching_cubes, vol, 0.0, 1)
    ok = (len(vc), len(fc)) == (len(vn), len(fn)) == (len(v1), len(f1))
    ok = ok and np.allclose(canon(vc, fc), canon(vn, fn), atol=1e-5, rtol=0)
    ok = ok and np.allclose(canon(v1, f1), canon(vn, fn), atol=1e-5, rtol=0)
    log("host_engines", engine="marching_cubes", nx=LATTICE_NX + 1, verts=len(vc),
        faces=len(fc), native_s=native_s, native_1thread_s=one_s, numpy_s=numpy_s,
        equal_to_numpy=bool(ok), cpus=os.cpu_count())
    if not ok:
        raise AssertionError("native marching cubes disagrees with the numpy reference")
    nx = 4 * LATTICE_NX + 1
    vol = bumpy_field(nx)
    threads = max(1, min(os.cpu_count() or 1, 8))
    (vt, ft), slab_s = host_call(native.mc.marching_cubes, vol, 0.0)
    (v1, f1), one_s = host_call(native.mc.marching_cubes, vol, 0.0, 1)
    ok = (len(vt), len(ft)) == (len(v1), len(f1))     # no duplicate survives the weld
    ok = ok and np.allclose(canon(vt, ft), canon(v1, f1), atol=1e-5, rtol=0)
    log("host_engines", engine="marching_cubes", nx=nx, threads=threads, verts=len(vt),
        faces=len(ft), native_s=slab_s, native_1thread_s=one_s, welded=bool(ok))
    if not ok:
        raise AssertionError(f"marching cubes on {threads} slabs differs from one thread")
    del vol, vt, ft, v1, f1
    from vtaco_tpu_torch.generate.generator import Generator3D

    R, box = LATTICE_NX - 1, 1.1
    ii = np.random.default_rng(0).permutation(LATTICE_NX ** 3)
    ii = np.stack(np.unravel_index(ii, (LATTICE_NX,) * 3), axis=1)
    p = (box * (ii / R - 0.5)).astype(np.float32)
    (got, resid), enc_s = host_call(Generator3D._lattice_encode_host, p, box, R, len(p))
    (want, resid_np), enc_np_s = host_call(Generator3D._lattice_encode_numpy, p, box, R, len(p))
    ok = np.array_equal(got, want) and np.array_equal(got, ii.T) and resid <= 1e-3
    log("host_engines", engine="lattice_encode", points=len(p), native_s=enc_s,
        numpy_s=enc_np_s, residual=resid, residual_numpy=resid_np, equal_to_numpy=bool(ok))
    if not ok:
        raise AssertionError("the native lattice encode disagrees with the numpy form")


def rel_err(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max())


def f7_phase(cfg, model, batch):
    """generation.matmul_precision under PyTorch's own TF32 flags (cuDNN's
    on, cuBLAS's off): VTacO_YCB's encode and contact gates at full width
    through Generator3D._encode_sample at 'highest' against the same with
    both flags off (within 1e-6 relative: the UNet3D grid and the
    ResNet-18 features), and at 'default' (TF32) as the control that the
    check sees TF32 (more than 1e-5 relative). The script's flags are put
    back after."""
    own = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    gens = {}
    for prec in ("highest", "default"):
        c = json.loads(json.dumps(cfg))
        c["generation"]["matmul_precision"] = prec
        gens[prec] = get_generator(model, c)
    out = {}
    # deterministic algorithms: the object encoder's scatter-mean adds with
    # atomics, which alone moves the grid by a few 1e-6 between two runs
    # of one configuration (11A); the ops without a deterministic kernel
    # are logged
    with deterministic() as nondeterministic:
        try:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
            defaults = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
            for prec, gen in gens.items():
                gen._encode_sample(model, batch, 0)                    # warm
                out[prec] = gen._encode_sample(model, batch, 0)
                if (torch.backends.cuda.matmul.allow_tf32,
                        torch.backends.cudnn.allow_tf32) != defaults:
                    raise AssertionError(f"f7: {prec} did not restore the process's flags")
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
            ref = gens["highest"]._encode_sample(model, batch, 0)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = own
    errs = {prec: {"grid": rel_err(c["grid"], ref[0]["grid"]),
                   "c_img": rel_err(g[2], ref[1][2])}
            for prec, (c, g) in out.items()}
    ok = (max(errs["highest"].values()) <= 1e-6 and min(errs["default"].values()) > 1e-5
          and out["highest"][1][0] == "contact")
    log("f7", process_flags="pytorch defaults (matmul off, cudnn on)",
        highest_vs_flags_off=errs["highest"], default_vs_flags_off=errs["default"],
        nondeterministic_ops=nondeterministic, ok=bool(ok))
    if not ok:
        raise AssertionError(f"f7: matmul_precision does not set the TF32 flags: {errs}")


def family_config(name, root, data, t2d_ckpt):
    """VTacO_YCB at full width, its graft from (a)'s checkpoint, with only
    the family's keys changed (tests/families.py makes the same changes at
    the tests' widths): r34/r50 the image encoder; pn2 PointNet++ and the
    point decoder without images or t2d model (the plain loss path); vox
    32³ voxel inputs, the voxel encoder on the 64³ grid with VTacO_YCB's
    UNet3D, and no hand encoder, images or t2d model (the JAX package
    fails on a voxel batch with any of them, F8 (c)); att the attention
    decoder on chunks of 2048 points."""
    cfg = pipeline_config("configs/VTacO/VTacO_YCB.yaml", root, data, f"fam_{name}")
    cfg["model"]["encoder_t2d_kwargs"]["model_file"] = t2d_ckpt
    cfg["generation"]["mc_level"] = "mean"
    cfg["training"].update(validate_every=FAMILY_ITERS, checkpoint_every=FAMILY_ITERS)
    m = cfg["model"]
    if name in ("r34", "r50"):
        m["encoder_img"] = {"r34": "Resnet34", "r50": "Resnet50"}[name]
    elif name == "pn2":
        m.update(encoder="pointnet_plus_plus", decoder="simple_local_point",
                 with_img=False, encoder_t2d=False)
    elif name == "vox":
        cfg["data"].update(input_type="voxels", voxels_file="model.binvox")
        m.update(encoder="voxel_simple_local", encoder_hand=False, with_img=False,
                 encoder_t2d=False)
        m["encoder_kwargs"] = {"plane_type": ["grid"], "grid_resolution": 64,
                               "unet3d": True,
                               "unet3d_kwargs": m["encoder_kwargs"]["unet3d_kwargs"]}
    elif name == "att":
        m["decoder"] = "attention_local"
        m["decoder_kwargs"]["input_size"] = FAMILY_ATT_CHUNK
        cfg["data"]["points_subsample"] = FAMILY_ATT_CHUNK
        cfg["generation"]["batch_size"] = FAMILY_ATT_CHUNK
    return cfg


def family_against_cpu(name, cfg, trainer, batch):
    """One 'highest' step of the family on the card against the CPU's
    float32 step (step_against_cpu), to TRAIN_RTOL and GRAD_COS."""
    rel, cos, ratio, cpu_s = step_against_cpu(cfg, trainer, batch, torch.float32)
    log("families", family=name, vs_cpu="loss_rel_err", cpu_step_s=cpu_s, **rel)
    log("families", family=name, vs_cpu="grad_cosine", **cos)
    log("families", family=name, vs_cpu="grad_norm_ratio", **ratio)
    if max(rel.values()) > TRAIN_RTOL or min(cos.values()) < GRAD_COS:
        raise AssertionError(f"families: {name}'s card step differs from the CPU "
                             f"step: {rel} {cos}")


def family_train(name, cfg):
    """cli.train's loop for FAMILY_ITERS steps (validated and checkpointed
    at the last), the validation's metrics, then family_steps. Returns the
    checkpoint's absolute path."""
    t0 = time.perf_counter()
    (trainer, it), _ = printed(loop.train, cfg, max_iters=FAMILY_ITERS, device="cuda",
                               seed=0)
    torch.cuda.synchronize()
    out_dir = cfg["training"]["out_dir"]
    ckpt = os.path.abspath(os.path.join(out_dir, "model.ckpt"))
    if not os.path.exists(ckpt):
        raise AssertionError(f"families: {name}'s loop wrote no checkpoint")
    family_validate(name, cfg, trainer, loop_iters=it, loop_s=time.perf_counter() - t0)
    family_steps(name, cfg, trainer)
    return ckpt


def family_validate(name, cfg, trainer, **fields):
    """The trainer's validation on the val split, logged with ``fields``."""
    val = trainer.evaluate(BatchLoader(get_dataset("val", cfg, return_idx=True), 1,
                                       shuffle=False, num_workers=2))
    log("families", family=name, **fields,
        params=sum(p.numel() for p in trainer.model.parameters()),
        **{f"val_{k}": v for k, v in val.items()})
    if name == "vox" and not 0 <= val.get("iou_voxels", -1) <= 1:
        raise AssertionError(f"families: vox validated no iou_voxels: {val}")


def family_steps(name, cfg, trainer):
    """FAMILY_TIMED warm steps and their peak memory, then the step against
    the CPU."""
    loader = BatchLoader(get_dataset("train", cfg), cfg["training"]["batch_size"],
                         num_workers=4, seed=1)
    batches = take(loader, FAMILY_TIMED + 1)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for b in batches[:FAMILY_TIMED]:
        t0 = time.perf_counter()
        trainer.train_step(b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    log("families", family=name, matmul_precision=trainer.matmul_precision,
        step_s=float(np.median(times)), step_s_each=times,
        train_peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    family_against_cpu(name, cfg, trainer, batches[-1])


def family_pn2(root, cfg):
    """fam_pn2 without its CLIs: the JAX package's train loop and generation
    CLI fail on the point decoder (its Trainer initializes through
    decode_img), and the port's raise there (F8 (d)), which is checked
    first. Then the Trainer's FAMILY_ITERS steps and validation, the
    family_steps, and one test object's mesh through the Generator (the
    chunked module decode) as family_generate times and counts it."""
    try:
        printed(loop.train, cfg, max_iters=1, device="cuda", seed=0)
    except NotImplementedError as e:
        if "F8 (d)" not in str(e):
            raise
    else:
        raise AssertionError("families: cli.train trained simple_local_point")
    try:
        cli_generate(root, cfg, "model.ckpt", "fam_pn2_cli", "--max-samples", "1")
    except NotImplementedError as e:
        if "F8 (d)" not in str(e):
            raise
    else:
        raise AssertionError("families: cli.generate served simple_local_point")
    log("families", family="pn2", cli_train="raises F8 (d)", cli_generate="raises F8 (d)")
    torch.manual_seed(0)
    model = get_model(cfg)
    trainer = Trainer.from_config(model, cfg, mesh_bank=loop.build_mesh_bank(cfg, "cuda"))
    loader = BatchLoader(get_dataset("train", cfg), cfg["training"]["batch_size"],
                         num_workers=4, seed=0)
    t0 = time.perf_counter()
    for b in take(loader, FAMILY_ITERS):
        trainer.train_step(b)
    torch.cuda.synchronize()
    family_validate("pn2", cfg, trainer, trainer_iters=FAMILY_ITERS,
                    trainer_s=time.perf_counter() - t0)
    family_steps("pn2", cfg, trainer)
    return family_generate("pn2", root, cfg, serve=lambda: generator_mesh(cfg, model))


def generator_mesh(cfg, model):
    """One test object's object mesh through the Generator in eval mode:
    ({"n", "emd_mean", "cd_mean"}, None, the seconds it took)."""
    model.eval()
    gen = get_generator(model, cfg)
    batch = next(iter(BatchLoader(get_dataset("test", cfg, return_idx=True), 1,
                                  shuffle=False, num_workers=1)))
    t0 = time.perf_counter()
    _, emd, cd = gen.generate_obj_mesh_wnf(model, batch)
    torch.cuda.synchronize()
    return {"n": 1, "emd_mean": emd, "cd_mean": cd}, None, time.perf_counter() - t0


def family_generate(name, root, cfg, ckpt=None, serve=None):
    """cli.generate on one test object from the family's checkpoint (or
    ``serve()``, which returns what cli_generate does, with no files), the
    mesh's time and its encode, gates, decode, marching cubes and EMD
    split, its peak memory,
    and the launches (counters zeroed just before, read just after):
    K1 once for fam_r50, nothing for the others. A voxel batch raises F8
    (c) instead, as the JAX package fails there."""
    from vtaco_tpu_torch.generate.generator import Generator3D
    from vtaco_tpu_torch.models.conv_onet import ConvOccupancyNetwork

    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    run = f"fam_{name}_generate"
    with timed_methods(Generator3D, ("generate_obj_mesh_wnf", "_build_gates",
                                     "eval_points_dense")) as t, \
            timed_methods(ConvOccupancyNetwork, ("encode_inputs",)) as te, \
            timed_methods(type(native.mc), ("marching_cubes",), sync=False) as mc, \
            timed_methods(metrics, ("earth_mover_distance",), sync=False) as emd:
        try:
            line, files, seconds = serve() if serve else cli_generate(
                root, cfg, ckpt, run, "--max-samples", "1")
        except NotImplementedError as e:
            if name != "vox" or "F8 (c)" not in str(e):
                raise
            log("families", family=name, cli_generate="raises F8 (c)")
            return read_counters()
    launches = read_counters()
    log("families", family=name, cli_s=seconds, mesh_s=t["generate_obj_mesh_wnf"],
        encode_s=te["encode_inputs"], gates_s=t["_build_gates"],
        decode_s=t["eval_points_dense"], marching_cubes_s=mc["marching_cubes"],
        emd_s=emd["earth_mover_distance"], mesh_peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30, **line,
        **{f"launches_{k}": v for k, v in launches.items() if v})
    if name == "vox":
        raise AssertionError("families: cli.generate meshed a voxel batch")
    if line["n"] != 1 or not np.isfinite(line["cd_mean"]) or (files is not None and not any(
            f.endswith("_obj.off") for f in files)):
        raise AssertionError(f"families: {name}'s cli.generate gave {line} {files}")
    if name == "r50":
        launched_only("families", launches, {"fused_trunk_gated_cn": 1})
    elif any(launches.values()):
        raise AssertionError(f"families: {name} launched {launches}; its decoder "
                             "runs no kernel")
    return launches


def family_lattice(cfg, ckpt):
    """fam_vox's eval_points on the 128³ lattice of the box (the complete
    cube: the dense route, K2 ungated) from its checkpoint, on one test
    object. Returns the launches (counters zeroed just before)."""
    model = get_model(cfg)
    CheckpointIO(cfg["training"]["out_dir"], model=model).load(ckpt)
    model.eval()
    gen = get_generator(model, cfg)
    batch = next(iter(BatchLoader(get_dataset("test", cfg, return_idx=True), 1,
                                  shuffle=False, num_workers=1)))
    with torch.no_grad():
        c = model.encode_inputs(torch.as_tensor(np.asarray(batch["inputs"]),
                                                device=next(model.parameters()).device))
    pts = (1 + gen.padding) * make_3d_grid((-0.5,) * 3, (0.5,) * 3, (LATTICE_NX,) * 3)
    zero_counters()
    t0 = time.perf_counter()
    vals = gen.eval_points(model, pts, c)
    torch.cuda.synchronize()
    launches = read_counters()
    log("families", family="vox", eval_points=len(pts), eval_points_s=time.perf_counter() - t0,
        **{f"launches_{k}": v for k, v in launches.items() if v})
    if vals.shape != (len(pts),) or not np.isfinite(vals).all():
        raise AssertionError("families: vox's lattice eval_points gave bad logits")
    launched_only("families", launches, {"fused_trunk_cn": 1})
    return launches


def families_phase(root, data, t2d_ckpt):
    """(j) The other model families (ROADMAP item 11) at full width on the
    pipeline's set: fam_r34's step against the CPU; for fam_r50, fam_vox
    and fam_att cli.train, the step against the CPU and cli.generate on
    one test object; fam_pn2 the same through the Trainer and the
    Generator, its CLIs raising F8 (d) (family_pn2); fam_vox's lattice
    eval_points. Returns the launches by path."""
    t0 = time.perf_counter()
    write_voxels(data[0], VOX_RES)
    paths = {}
    for name in FAMILIES:
        cfg = family_config(name, root, data, t2d_ckpt)
        if name == "r34":
            torch.manual_seed(0)
            model = get_model(cfg)
            trainer = Trainer.from_config(model, cfg,
                                          mesh_bank=loop.build_mesh_bank(cfg, "cuda"))
            loader = BatchLoader(get_dataset("train", cfg),
                                 cfg["training"]["batch_size"], num_workers=4, seed=1)
            family_against_cpu(name, cfg, trainer, take(loader, 1)[0])
            del model, trainer
            continue
        if name == "pn2":
            paths["fam_pn2_generate"] = family_pn2(root, cfg)
            continue
        ckpt = family_train(name, cfg)
        paths[f"fam_{name}_cli_generate"] = family_generate(name, root, cfg, ckpt)
        if name == "vox":
            paths["fam_vox_eval_points"] = family_lattice(cfg, ckpt)
        torch.cuda.empty_cache()
    log("families", seconds=time.perf_counter() - t0)
    return paths


def pipeline_phase():
    """The paper's three stages through the port's entry points at full
    width on one synthetic set: (a) pretrain the tactile depth stack,
    (b) train VTacO_YCB with its graft, (c) train VTacOH_YCB, (d, e)
    reconstruct through the generation CLI, (f) the loop's visualization,
    (h) cli.generate --batched, (i) crop, (j) the other model families, (g) the
    *_fast configs. Returns the kernel launches of the CLI's VTacO and
    VTacOH paths, of its batched path, and of the families' and the fast
    phase's by path."""
    root = os.path.join(REPO, "out", "chip_smoke_pipeline")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    data = synthetic.generate(
        os.path.join(root, "data"), n_models=PIPELINE_MODELS, n_query=PIPELINE_QUERY,
        n_surface=20_000, img_h=PIPELINE_IMG[0], img_w=PIPELINE_IMG[1], seed=0,
        splits=(("train", 0.75), ("val", 0.125), ("test", 0.125)))
    log("pipeline", synthetic_s=time.perf_counter() - t0, models=PIPELINE_MODELS,
        n_query=PIPELINE_QUERY, images="5x%dx%d" % PIPELINE_IMG)
    tac = tactile_stage(root, data)
    clock("tactile")
    vt = vtaco_stage(root, data, tac[1])
    clock("train")
    vh = vtacoh_stage(root, data)
    clock("vtacoh_train")
    launches = generate_stage(root, vt, tac, vh)
    batched = batched_cli_stage(root, vt)
    band = band_cli_stage(root, vt)
    par = parallel_phase(root, data, vt)
    visualize_stage(root, vt, tac, vh)
    clock("generate_parallel_visualize")
    crop_stage(root, data)
    clock("crop")
    families = families_phase(root, data, tac[1])
    clock("families")
    fast = fast_phase(root, data, tac[1])
    clock("fast")
    shutil.rmtree(root)
    return launches, batched, dict(fast, parallel=par, band_cli_generate=band, **families)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is visible", file=sys.stderr)
        return 2
    t_start = T_START[0] = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(smi_line(), flush=True)
    name = torch.cuda.get_device_name(0)
    variant, peak = peaks(name)
    log("device", name=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda, peak_row=variant,
        f32_tflops=peak[0] / 1e12, tf32_tflops=peak[1] / 1e12,
        hbm_tbs=peak[2] / 1e12,
        tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
        tf32_cudnn=torch.backends.cudnn.allow_tf32)

    t0 = time.perf_counter()
    reports = build.build_all()
    log("build", seconds=round(time.perf_counter() - t0, 3), built=sorted(reports))
    for src, report in reports.items():
        for line in report.splitlines():
            if any(k in line for k in ("entry", "registers", "spill", "smem")):
                print(f"[ptxas {src}] {line.strip()}")

    host_engines_phase()
    init_phase(dev)
    helpers_phase(dev)
    clock("helpers")
    rows = kernel_phase(dev, peak)
    rows.update(window_kernel_phase(dev, peak))
    rows["fused_trunk_cn_batched"] = batched_kernel_phase(dev, peak)
    clock("kernels")
    generic_rows = widths_phase(dev, peak)
    clock("widths")
    cfg, model, batch, gens = build_model()
    f7_phase(cfg, model, batch)
    launches = main_path_phase(dev, cfg, model, batch, gens)
    eval_launches = eval_points_phase(dev, model, batch, gens)
    batched_paths = batched_phase(dev, peak, cfg, model)
    batched_paths.update(band_phase(dev, cfg, model, batch))
    options_phase(dev, cfg)
    del model, gens
    clock("main_eval_points_batched_band_options")
    wide_launches, wide_rows = wide_path_phase(dev, peak)
    jax_launches = jax_ckpt_phase(dev)
    clock("wide_jax_ckpt")
    h_cfg, h_model, h_batch, h_gen = build_vtacoh()
    h_mesh, cimg_rows = vtacoh_mesh_phase(dev, peak, h_cfg, h_model, h_batch, h_gen)
    batched_paths["vtacoh_band_mesh"] = band_tips(dev, h_cfg, h_model, h_batch)
    h_eval, row = vtacoh_query_phase(dev, peak, h_model, h_batch, h_gen)
    cimg_rows = {"fused_trunk_cn": cimg_rows, "fused_trunk_window_cn": row}
    del h_model, h_gen
    clock("vtacoh")
    p_cfg, p_model, p_batch, p_gens = build_planes()
    planes_mesh, planes_eval = planes_phase(dev, p_cfg, p_model, p_batch, p_gens)
    del p_model, p_gens
    clock("planes")
    (cli_launches, h_cli), cli_batched, fast_launches = pipeline_phase()
    replaced = {   # the source of each kernel and the pallas_call it replaces
        "fused_trunk_cn": ("trunk.cu", "vtaco_tpu/ops/pallas/decode.py:522"),
        # K2 under the JAX package's vmap (decode_dense_batched,
        # decode_points_batched): the same pallas_call with an object axis
        "fused_trunk_cn_batched": ("trunk.cu", "vtaco_tpu/ops/pallas/decode.py:522"),
        "fused_trunk_gated_cn": ("trunk.cu", "vtaco_tpu/ops/pallas/decode.py:641"),
        "fused_trunk_window_cn": ("window.cu", "vtaco_tpu/ops/pallas/decode.py:442"),
        "fused_trunk_window_cn:gated": ("window.cu",
                                        "vtaco_tpu/ops/pallas/decode.py:406"),
    }
    # each kernel's launches on every path: VTacO's mesh (K1/K2) and
    # eval_points (K3/K4) paths, VTacOH's (K2 and K3 on fingertip rows,
    # counted apart as ':c_img') and both generation CLIs
    paths = {"mesh": launches, "eval_points": eval_launches, "vtacoh_mesh": h_mesh,
             "vtacoh_eval_points": h_eval, "planes_mesh": planes_mesh,
             "planes_eval_points": planes_eval, "cli_generate": cli_launches,
             "vtacoh_cli_generate": h_cli, **batched_paths,
             "cli_generate_batched": cli_batched, **fast_launches,
             "wide_path": wide_launches, "jax_ckpt": jax_launches}
    kernels = []
    for kname, (source, replaces) in replaced.items():
        r = rows[kname]
        modes = [kname] + ([f"{kname}:c_img"] if kname in cimg_rows else [])
        by_path = {path: sum(counts.get(m, 0) for m in modes)
                   for path, counts in paths.items()}
        entry = {
            "name": kname, "route": "cuda",
            "source": f"vtaco_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["err"], cimg_rows[kname]["err"]) if kname in cimg_rows
            else r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "bound_f32_ms": r["bound_f32_ms"],
            "lattice_ms": r.get("lattice_ms"),
            "lattice_bound_ms": r.get("lattice_bound_ms"), "library_ms": None,
        }
        if "singles_ms" in r:    # K2 batched: BATCH_B single-object launches
            entry.update(objects=BATCH_B, singles_ms=r["singles_ms"],
                         lattice_singles_ms=r["lattice_singles_ms"])
        if kname in cimg_rows:   # the modes launched, and the c_img mode's reading
            c = cimg_rows[kname]
            entry["modes_launched"] = {
                "coords": sum(counts.get(kname, 0) for counts in paths.values()),
                "c_img": sum(counts.get(f"{kname}:c_img", 0) for counts in paths.values())}
            entry["c_img"] = {k: c[k] for k in ("err", "ms", "plain_ms", "bound_ms",
                                                  "bound_by", "gate_tips_ms")}
        kernels.append(entry)
    # the generic kernel's modes: the numbers of the hidden = C = WIDE_MODEL
    # path, whose launches they count, each on the inputs the path gave it;
    # every widths case beside them
    for mode in ("K1", "K2", "K2_batched", "K3", "K4"):
        kname = f"trunk_any:{mode}"
        fused = {"K1": "fused_trunk_gated_cn", "K2": "fused_trunk_cn",
                 "K2_batched": "fused_trunk_cn_batched", "K3": "fused_trunk_window_cn",
                 "K4": "fused_trunk_window_cn:gated"}[mode]
        by_path = {path: counts.get(kname, 0) + counts.get(f"{kname}:c_img", 0)
                   for path, counts in paths.items()}
        r = wide_rows[mode]
        extra = {}
        if mode == "K2":      # its c_img mode, timed apart in the widths phase
            extra["c_img"] = {case: {k: x[k] for k in ("err", "ms", "plain_ms", "bound_ms",
                                                        "bound_by")}
                              for case, x in generic_rows["K2:c_img"].items()}
        kernels.append({
            "name": kname, "route": "cuda", "source": "vtaco_tpu_torch/csrc/trunk_any.cu",
            "replaces": replaced[fused][1], "widths": r["widths"],
            "launches": sum(by_path.values()),
            "launches_by_path": {k: v for k, v in by_path.items() if v},
            "max_abs_err": max([r["err"]] + [x["err"] for m in (mode, f"{mode}:c_img")
                                             for x in generic_rows.get(m, {}).values()]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "bound_f32_ms": r["bound_f32_ms"],
            "library_ms": None,
            "by_width": {case: {k: x[k] for k in ("err", "ms", "plain_ms", "bound_ms",
                                                   "bound_by", "bound_f32_ms")}
                         for case, x in generic_rows[mode].items()}, **extra})
    log("done", seconds=round(time.perf_counter() - t_start, 3))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
