"""Device-resident dataset with augmentation on the device (port of
vtaco_tpu/data/device_data.py:1-184).

The raw fields of every model of a split are stacked once on the card
(images as uint8, a quarter of their float32 size), and each training batch
is gathered and augmented there: query-point subsampling, cloud
subsampling with Gaussian noise, and tactile image noise with the legacy
double division by 255, the transforms of data.fields and
data.transforms. Per step the host sends B model ids instead of the
batch's arrays.

The draws come from a ``torch.Generator`` on the device; torch cannot
replay jax.random, so ``_sample`` also takes them explicitly (the tests
feed the JAX package's draws in). ``DeviceBatchLoader.take_ids`` shuffles
with numpy's ``default_rng(seed)`` as the JAX loader does, so its id
stream equals the JAX package's.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from vtaco_tpu_torch.data.fields import VoxelsField

# the stacked fields, in the JAX package's order
FIELDS = ("points", "occ", "contact", "pc_hand", "mano", "wrist", "cam_pos", "cam_rot",
          "pc_points", "pc_normals", "pc_ply", "img", "depth", "touch_success")


def _load(path):
    with np.load(path, allow_pickle=True) as z:
        return {k: z[k] for k in z.files}


class DeviceDataset:
    """Stacked raw fields of every model of a split, on ``device``."""

    def __init__(self, dataset, legacy_image_scale=True, noise_std=7.0,
                 pointcloud_noise=0.005, device="cuda"):
        """dataset: a data.core.Shapes3dDataset of the object-scale configs
        (each model directory holds points.npz and pointcloud.npz)."""
        if isinstance(dataset.fields.get("inputs"), VoxelsField):
            raise NotImplementedError(
                "device-resident data for data.input_type voxels: the JAX "
                "package's DeviceDataset stacks the point cloud as the inputs "
                "(vtaco_tpu/data/device_data.py:126), which its voxel encoder "
                "refuses at vtaco_tpu/models/voxels.py:46 (F8 (c), ROADMAP.md §3)")
        self.legacy_image_scale = legacy_image_scale
        self.noise_std = noise_std
        self.pointcloud_noise = pointcloud_noise
        self.device = torch.device(device)
        self.names = []
        cols = {k: [] for k in FIELDS}
        for entry in dataset.models:
            mdir = os.path.join(dataset.dataset_folder, entry["category"], entry["model"])
            pd = _load(os.path.join(mdir, "points.npz"))
            cd = _load(os.path.join(mdir, "pointcloud.npz"))
            self.names.append(entry["model"][:-5])
            f32 = {"points": pd["points"], "occ": pd["occupancies"],
                   "contact": pd["contact"], "pc_hand": pd["pc_hand"], "mano": pd["mano"],
                   "wrist": pd["wrist_rot"], "cam_pos": pd["cam_pos"],
                   "cam_rot": pd["cam_rot"].astype(np.float32) / 180 * np.pi,
                   "pc_points": cd["points"], "pc_normals": cd["normals"],
                   "pc_ply": cd["pc_ply"], "depth": cd["depth"]}
            for k, v in f32.items():
                cols[k].append(np.asarray(v).astype(np.float32))
            img = np.asarray(cd["img"])
            if img.ndim == 4 and img.shape[1] == 3 and img.shape[-1] != 3:
                img = img.transpose(0, 2, 3, 1)
            cols["img"].append(np.clip(img, 0, 255).astype(np.uint8))
            cols["touch_success"].append(np.asarray(cd["touch_success"]).astype(bool))
        self.n_models = len(self.names)
        self.data = ({k: torch.as_tensor(np.stack(v), device=self.device)
                      for k, v in cols.items()} if self.n_models else {})

    def nbytes(self):
        return sum(v.numel() * v.element_size() for v in self.data.values())

    def draws(self, batch_size, n_points, n_cloud, generator=None):
        """The random draws of one batch, from ``generator`` on the device:
        {"idx": (B, n_points) query points, "cidx": (B, n_cloud) cloud
        points, "noise_pc": (B, n_cloud, 3) and "noise_img": (B, 5, H, W, 3)
        standard normals}."""
        d, dev = self.data, self.device
        B = batch_size
        return {
            "idx": torch.randint(0, d["points"].shape[1], (B, n_points),
                                 generator=generator, device=dev),
            "cidx": torch.randint(0, d["pc_points"].shape[1], (B, n_cloud),
                                  generator=generator, device=dev),
            "noise_pc": torch.randn((B, n_cloud, 3), generator=generator, device=dev),
            "noise_img": torch.randn((B,) + tuple(d["img"].shape[1:]), generator=generator,
                                     device=dev),
        }

    def _sample(self, ids, n_points: int, n_cloud: int, generator=None, draws=None):
        """(B,) model ids on the device → the batch dict under the host
        loader's keys, gathered and augmented on the device; ``draws``
        (the dict of ``draws``) given instead of ``generator``'s."""
        d = self.data

        def g(k):
            return d[k][ids]

        if draws is None:
            draws = self.draws(ids.shape[0], n_points, n_cloud, generator)
        idx = torch.as_tensor(draws["idx"], dtype=torch.int64, device=self.device)

        def take(arr):
            return torch.gather(arr, 1, idx[..., None].expand(-1, -1, 3)
                                if arr.dim() == 3 else idx)

        cidx = torch.as_tensor(draws["cidx"], dtype=torch.int64, device=self.device)
        cloud = torch.gather(g("pc_points"), 1, cidx[..., None].expand(-1, -1, 3))
        cloud = cloud + self.pointcloud_noise * torch.as_tensor(draws["noise_pc"],
                                                                device=self.device)
        img = g("img").to(torch.float32)
        img = torch.clamp(img + self.noise_std * torch.as_tensor(draws["noise_img"],
                                                                 device=self.device),
                          0, 255) / 255.0
        if self.legacy_image_scale:
            img = img / 255.0
        return {
            "points": take(g("points")),
            "points.occ": take(g("occ")),
            "points.contact": take(g("contact")),
            "points.pc_hand": g("pc_hand"),
            "points.mano": g("mano"),
            "points.wrist": g("wrist"),
            "points.cam_pos": g("cam_pos"),
            "points.cam_rot": g("cam_rot"),
            "inputs": cloud,
            "inputs.pc_ply": g("pc_ply"),
            "inputs.img": img,
            "inputs.depth": g("depth"),
            "inputs.touch_success": g("touch_success"),
        }

    def sample_batch(self, ids, n_points, n_cloud, generator=None, draws=None):
        """(B,) host ids → the batch dict of device tensors and the models'
        names (``points.name``, for the MeshBank)."""
        ids = np.asarray(ids, np.int64)
        batch = self._sample(torch.as_tensor(ids, device=self.device), n_points, n_cloud,
                             generator, draws)
        batch["points.name"] = [self.names[int(i)] for i in ids]
        return batch


class DeviceBatchLoader:
    """Shuffling epoch iterator over a DeviceDataset (drop_last), and the
    id stream of the fused steps."""

    def __init__(self, device_dataset: DeviceDataset, batch_size, n_points, n_cloud,
                 seed=0, shuffle=True):
        self.ds = device_dataset
        self.batch_size = batch_size
        self.n_points = n_points
        self.n_cloud = n_cloud
        self.shuffle = shuffle
        self.host_rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=device_dataset.device).manual_seed(seed)
        self._id_buf = np.empty(0, np.int64)

    def __len__(self):
        return self.ds.n_models // self.batch_size

    def __iter__(self):
        order = np.arange(self.ds.n_models)
        if self.shuffle:
            self.host_rng.shuffle(order)
        for i in range(0, len(order) - self.batch_size + 1, self.batch_size):
            yield self.ds.sample_batch(order[i:i + self.batch_size], self.n_points,
                                       self.n_cloud, self.generator)

    # -- fused steps ----------------------------------------------------
    def next_key(self):
        """The generator of the next block's batch draws: one stream on the
        device across blocks, as the JAX loader splits one key chain."""
        return self.generator

    def take_ids(self, k):
        """(k, B) int32 model ids from an infinite shuffled epoch stream
        (blocks may span epoch boundaries; partial epoch tails are kept)."""
        need = k * self.batch_size
        buf = self._id_buf
        while buf.size < need:
            order = np.arange(self.ds.n_models)
            if self.shuffle:
                self.host_rng.shuffle(order)
            buf = np.concatenate([buf, order])
        self._id_buf = buf[need:]
        return buf[:need].reshape(k, self.batch_size).astype(np.int32)
