"""Matplotlib debug plots of voxels and point clouds (port of
vtaco_tpu/utils/visualize.py; the reference's src/utils/visualize.py:7-85).
matplotlib is imported at the first plot, with the headless Agg backend:
the package does not need it otherwise."""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def visualize_data(data, data_type, out_file):
    """Plot by data type: 'voxels' or 'pointcloud'; None and 'idx' draw
    nothing."""
    if data_type == "voxels":
        visualize_voxels(data, out_file=out_file)
    elif data_type == "pointcloud":
        visualize_pointcloud(data, out_file=out_file)
    elif data_type is None or data_type == "idx":
        pass
    else:
        raise ValueError(f'Invalid data_type "{data_type}"')


def _axes(ax):
    ax.set_xlabel("Z")
    ax.set_ylabel("X")
    ax.set_zlabel("Y")


def _finish(plt, fig, ax, out_file, show):
    ax.view_init(elev=30, azim=45)
    if out_file is not None:
        plt.savefig(out_file)
    if show:
        plt.show()
    plt.close(fig)


def visualize_voxels(voxels, out_file=None, show=False):
    """3-d voxel plot."""
    plt = _plt()
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    ax.voxels(np.asarray(voxels).transpose(2, 0, 1), edgecolor="k")
    _axes(ax)
    _finish(plt, fig, ax, out_file, show)


def visualize_pointcloud(points, normals=None, out_file=None, show=False):
    """3-d scatter, with the normals as arrows when given."""
    plt = _plt()
    points = np.asarray(points)
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(points[:, 2], points[:, 0], points[:, 1], s=2)
    if normals is not None:
        normals = np.asarray(normals)
        ax.quiver(points[:, 2], points[:, 0], points[:, 1],
                  normals[:, 2], normals[:, 0], normals[:, 1], length=0.1, color="k")
    _axes(ax)
    ax.set_xlim(-0.5, 0.5)
    ax.set_ylim(-0.5, 0.5)
    ax.set_zlim(-0.5, 0.5)
    _finish(plt, fig, ax, out_file, show)
