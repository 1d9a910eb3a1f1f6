"""Dataset and host input pipeline (port of vtaco_tpu/data/core.py:29-384
and the data-field factory of vtaco_tpu/core/factory.py:192-218).

``Shapes3dDataset`` reads the reference's directory-per-category layout:
model lists from ``<split>.lst``, an optional ``metadata.yaml``, and each
sample as the flattened union of its fields' dicts (a nested dict, such
as the crop fields' per-plane ``ind`` and ``normalized``, flattens to
``<field>.<key>.<plane>``); a sample whose field fails to load is
dropped. ``BatchLoader`` is a shuffling batcher whose worker threads
prefetch fixed-shape numpy batch dicts.

With ``data.input_type: pointcloud_crop`` every sample is cut to a crop
volume (``get_vol_info``): in the train split a cube of the crop
resolution times ``unit_size`` around a centre drawn uniformly within the
cloud's extent from numpy's global random state, in the other splits the
whole scene's volume (``decide_total_volume_range``); the crop fields
receive that volume in place of the category index, and the sample
carries ``pointcloud_crop`` True. With ``data.input_type: voxels`` the
inputs are each model's binvox grid (``data.voxels_file``); that file in a
val/test split also adds the ``voxels`` field for the voxel IoU.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import yaml

from vtaco_tpu_torch.data import fields as F
from vtaco_tpu_torch.data.transforms import (
    Compose,
    PointcloudNoise,
    SubsamplePointcloud,
    SubsamplePoints,
)
from vtaco_tpu_torch.ops.geometry import (
    crop_levels,
    decide_total_volume_range,
    update_reso,
)

logger = logging.getLogger(__name__)


class Shapes3dDataset:
    def __init__(self, dataset_folder, fields, split=None, categories=None,
                 no_except=True, transform=None, cfg=None):
        self.dataset_folder = dataset_folder
        self.fields = fields
        self.no_except = no_except
        self.transform = transform
        self.cfg = cfg
        self.split = split

        if categories is None:
            categories = [c for c in sorted(os.listdir(dataset_folder))
                          if os.path.isdir(os.path.join(dataset_folder, c))]
        metadata_file = os.path.join(dataset_folder, "metadata.yaml")
        if os.path.exists(metadata_file):
            with open(metadata_file) as f:
                self.metadata = yaml.safe_load(f)
        else:
            self.metadata = {c: {"id": c, "name": "n/a"} for c in categories}
        for c_idx, c in enumerate(categories):
            self.metadata[c]["idx"] = c_idx

        self.models = []
        for c in categories:
            subpath = os.path.join(dataset_folder, c)
            if not os.path.isdir(subpath):
                logger.warning("Category %s does not exist in dataset.", c)
                continue
            if split is None:
                models_c = sorted(d for d in os.listdir(subpath)
                                  if os.path.isdir(os.path.join(subpath, d)))
            else:
                with open(os.path.join(subpath, split + ".lst")) as f:
                    models_c = [m for m in f.read().split("\n") if m]
            self.models += [{"category": c, "model": m} for m in models_c]

        self.crop = cfg is not None and cfg["data"].get("input_type") == "pointcloud_crop"
        if self.crop:
            recep_field, self.depth = crop_levels(cfg["model"]["encoder_kwargs"])
            query_vol_metric = (100000 if cfg["generation"].get("sliding_window")
                                else cfg["data"]["padding"] + 1)
            (self.total_input_vol, self.total_query_vol,
             self.total_reso) = decide_total_volume_range(
                query_vol_metric, recep_field, cfg["data"]["unit_size"], self.depth)

    def get_vol_info(self, model_path):
        """The crop volume of one sample: {"plane_type", "reso", "input_vol",
        "query_vol"} (volumes as [lower (3,), upper (3,)])."""
        cfg = self.cfg
        query_vol_size = cfg["data"]["query_vol_size"]
        unit_size = cfg["data"]["unit_size"]
        field_name = cfg["data"]["pointcloud_file"]
        recep_field = crop_levels(cfg["model"]["encoder_kwargs"])[0]
        if cfg["data"].get("multi_files") is None:
            file_path = os.path.join(model_path, field_name)
        else:
            num = np.random.randint(cfg["data"]["multi_files"])
            file_path = os.path.join(model_path, field_name,
                                     "%s_%02d.npz" % (field_name, num))
        with np.load(file_path) as z:
            p = z["points"]
        if self.split == "train":
            p_c = np.array([np.random.uniform(p[:, i].min(), p[:, i].max())
                            for i in range(3)], np.float32)
            reso = update_reso(query_vol_size + recep_field - 1, self.depth)
            input_vol_metric = reso * unit_size
            query_vol_metric = query_vol_size * unit_size
            input_vol = [p_c - input_vol_metric / 2, p_c + input_vol_metric / 2]
            query_vol = [p_c - query_vol_metric / 2, p_c + query_vol_metric / 2]
        else:
            reso = self.total_reso
            input_vol, query_vol = self.total_input_vol, self.total_query_vol
        return {"plane_type": cfg["model"]["encoder_kwargs"]["plane_type"], "reso": reso,
                "input_vol": input_vol, "query_vol": query_vol}

    def __len__(self):
        return len(self.models)

    def __getitem__(self, idx):
        category = self.models[idx]["category"]
        model = self.models[idx]["model"]
        c_idx = self.metadata[category]["idx"]
        model_path = os.path.join(self.dataset_folder, category, model)
        data = {}
        if self.crop:
            c_idx = self.get_vol_info(model_path)
            data["pointcloud_crop"] = True
        for field_name, field in self.fields.items():
            try:
                field_data = field.load(model_path, idx, c_idx)
            except Exception:
                if self.no_except:
                    logger.warning("Error occurred when loading field %s of model %s",
                                   field_name, model, exc_info=True)
                    return None
                raise
            if isinstance(field_data, dict):
                for k, v in field_data.items():
                    if k is None:
                        data[field_name] = np.asarray(v, np.float32)
                    elif k == "name":
                        data[f"{field_name}.{k}"] = v
                    elif isinstance(v, dict):
                        for sub, sv in v.items():
                            data[f"{field_name}.{k}.{sub}"] = np.asarray(sv)
                    else:
                        data[f"{field_name}.{k}"] = np.asarray(v, np.float32)
            else:
                data[field_name] = field_data
        if self.transform is not None:
            data = self.transform(data)
        return data


def collate_batch(samples):
    """Stack sample dicts into one numpy batch dict, dropping None samples
    (failed loads); strings become lists."""
    samples = [s for s in samples if s is not None]
    if not samples:
        return None
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        out[k] = list(vals) if isinstance(vals[0], str) else np.stack(
            [np.asarray(v) for v in vals])
    return out


class BatchLoader:
    """Shuffling batch iterator; a producer thread fills a queue of
    ``prefetch`` batches, loading each batch's samples on ``num_workers``
    threads. drop_last (the default with shuffle) keeps every training
    batch the same shape; validation uses batch_size 1."""

    def __init__(self, dataset, batch_size, shuffle=True, num_workers=4,
                 drop_last=None, seed=None, prefetch=2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = shuffle if drop_last is None else drop_last
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        error = []
        closed = threading.Event()  # the consumer abandoned the iterator

        def put(item):
            """q.put that gives up once the consumer is gone, so that an
            abandoned iterator does not leave the producer blocked."""
            while not closed.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idxs in batches:
                        if not put(collate_batch(list(pool.map(
                                self.dataset.__getitem__, idxs)))):
                            return
            except BaseException as e:  # surfaced in the consumer
                error.append(e)
            finally:
                put(stop)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    if error:
                        raise error[0]
                    break
                if item is not None:
                    yield item
        finally:
            closed.set()


def get_data_fields(mode, cfg):
    """The query-point fields of a split: points (subsampled to
    data.points_subsample; the crop points field for pointcloud_crop)
    and, for val/test, points_iou and (with data.voxels_file) the voxel
    grid ``voxels``."""
    flds = {}
    if cfg["data"].get("points_file") is not None:
        field_cls = (F.PatchPointsField if cfg["data"]["input_type"] == "pointcloud_crop"
                     else F.PointsField)
        flds["points"] = field_cls(
            cfg["data"]["points_file"], SubsamplePoints(cfg["data"]["points_subsample"]),
            unpackbits=cfg["data"]["points_unpackbits"],
            multi_files=cfg["data"].get("multi_files"))
    if mode in ("val", "test", "vis"):
        if cfg["data"].get("points_iou_file") is not None:
            flds["points_iou"] = F.PointsField(
                cfg["data"]["points_iou_file"],
                unpackbits=cfg["data"]["points_unpackbits"],
                multi_files=cfg["data"].get("multi_files"))
        if cfg["data"].get("voxels_file") is not None:
            flds["voxels"] = F.VoxelsField(cfg["data"]["voxels_file"])
    return flds


def get_dataset(mode, cfg, return_idx=False):
    """The dataset of split ``mode`` ('train', 'val' or 'test')."""
    if cfg["data"]["dataset"] != "Shapes3D":
        raise ValueError(f'Invalid dataset "{cfg["data"]["dataset"]}"')
    split = cfg["data"][{"train": "train_split", "val": "val_split",
                         "test": "test_split"}[mode]]
    flds = get_data_fields(mode, cfg)
    input_type = cfg["data"]["input_type"]
    cloud_field = {"pointcloud": F.PointCloudField,
                   "partial_pointcloud": F.PartialPointCloudField,
                   "pointcloud_crop": F.PatchPointCloudField}.get(input_type)
    if cloud_field is not None:
        flds["inputs"] = cloud_field(
            cfg["data"]["pointcloud_file"],
            Compose([SubsamplePointcloud(cfg["data"]["pointcloud_n"]),
                     PointcloudNoise(cfg["data"]["pointcloud_noise"])]),
            multi_files=cfg["data"].get("multi_files"))
    elif input_type == "voxels":
        flds["inputs"] = F.VoxelsField(cfg["data"]["voxels_file"])
    elif input_type == "idx":
        flds["inputs"] = F.IndexField()
    elif input_type is not None:
        raise ValueError(f"Invalid input type ({input_type})")
    if return_idx:
        flds["idx"] = F.IndexField()
    return Shapes3dDataset(cfg["data"]["path"], flds, split=split,
                           categories=cfg["data"]["classes"], cfg=cfg)
