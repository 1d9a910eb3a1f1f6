"""Data transforms (a copy of vtaco_tpu/data/transforms.py, which the port
does not import): point-cloud noise and subsampling, query-point
subsampling with their labels. The draws come from numpy's global
random state, as in the JAX package."""

from __future__ import annotations

import numpy as np


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class PointcloudNoise:
    """Additive Gaussian noise on the main cloud. transforms.py:5-28."""

    def __init__(self, stddev):
        self.stddev = stddev

    def __call__(self, data):
        data_out = data.copy()
        points = data[None]
        noise = (self.stddev * np.random.randn(*points.shape)).astype(np.float32)
        data_out[None] = points + noise
        return data_out


class SubsamplePointcloud:
    """Random-with-replacement subsample of points+normals.
    transforms.py:30-55."""

    def __init__(self, N):
        self.N = N

    def __call__(self, data):
        data_out = data.copy()
        points = data[None]
        indices = np.random.randint(points.shape[0], size=self.N)
        data_out[None] = points[indices, :]
        data_out["normals"] = data["normals"][indices, :]
        return data_out


class SubsamplePoints:
    """Subsample query points along with occ and contact labels.

    transforms.py:58-113 (including the (Nt_out, Nt_in) in/out split mode).
    """

    def __init__(self, N):
        self.N = N

    def __call__(self, data):
        points = data[None]
        occ = data["occ"]
        data_out = data.copy()
        if isinstance(self.N, int):
            idx = np.random.randint(points.shape[0], size=self.N)
            data_out.update(
                {None: points[idx, :], "occ": occ[idx], "contact": data["contact"][idx]}
            )
        else:
            Nt_out, Nt_in = self.N
            occ_binary = occ >= 0.5
            points0 = points[~occ_binary]
            points1 = points[occ_binary]
            idx0 = np.random.randint(points0.shape[0], size=Nt_out)
            idx1 = np.random.randint(points1.shape[0], size=Nt_in)
            points_out = np.concatenate([points0[idx0], points1[idx1]], axis=0)
            occ_out = np.concatenate(
                [np.zeros(Nt_out, np.float32), np.ones(Nt_in, np.float32)], axis=0
            )
            volume = (occ_binary.sum() / len(occ_binary)).astype(np.float32)
            data_out.update({None: points_out, "occ": occ_out, "volume": volume})
        return data_out
