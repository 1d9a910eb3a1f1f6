"""The grasp generator: a pool of distinct synthetic grasps from the seed,
in the port's loader layout (B = 1 host arrays), with parameters from a
traffic file.

Each grasp holds an object of one of the shape families (ellipsoid, box,
sphere) at a seeded size and pose in the normalized frame, its partial
point cloud with the configuration's noise, a few fingers' points beside
it, five tactile images, the fingers' depth maps (1 to 5 fingers press a
dome of seeded radius into the gel; ``touch_success`` matches), the
sensors' poses placed so that each pressed dome lands on the object's
surface, and its world-frame scan (``inputs.pc_ply``). ``aim_hands``
places each hand so that its fingertips lie on or near the object, as in
a grasp.
"""

from __future__ import annotations

import math

import numpy as np

DEPTH_REST = 0.0215      # the gel at rest (the port's depth_origin default)
CAM_FOV = 60.0           # the sensor camera's field of view, degrees
ROT_OFF = (-math.pi / 2, 0.0, math.pi / 2)   # added to each sensor's rotation


def _rotation(rng):
    """A seeded rotation: Euler angles about z, y and x."""
    a, b, c = rng.uniform(-math.pi, math.pi, 3)
    ca, sa, cb, sb = math.cos(a), math.sin(a), math.cos(b), math.sin(b)
    cc, sc = math.cos(c), math.sin(c)
    rz = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]])
    ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
    rx = np.array([[1, 0, 0], [0, cc, -sc], [0, sc, cc]])
    return rz @ ry @ rx


def _surface(kind, half, n, rng):
    """(n, 3) points uniform on the surface of a shape with half-extents
    ``half``, and their outward normals, centred at the origin."""
    if kind == "box":
        areas = np.array([half[1] * half[2], half[0] * half[2], half[0] * half[1]] * 2)
        face = rng.choice(6, size=n, p=areas / areas.sum())
        p = rng.uniform(-1, 1, (n, 3)) * half
        axis, sign = face % 3, np.where(face < 3, 1.0, -1.0)
        p[np.arange(n), axis] = sign * half[axis]
        nrm = np.zeros((n, 3))
        nrm[np.arange(n), axis] = sign
        return p, nrm
    u = rng.standard_normal((n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    if kind == "sphere":
        return u * half[0], u
    p = u * half                                       # ellipsoid
    nrm = p / half ** 2
    return p, nrm / np.linalg.norm(nrm, axis=1, keepdims=True)


def _cam_rotation(rot):
    """The sensor's camera-to-world rotation for its Euler angles ``rot``
    (the port's pc_cam_to_world: the inverse of rot_z @ rot_x @ rot_y)."""
    dx, dy, dz = rot
    cx, sx, cy, sy, cz, sz = (math.cos(dx), math.sin(dx), math.cos(dy), math.sin(dy),
                              math.cos(dz), math.sin(dz))
    rot_x = np.array([[cx, 0, sx], [0, 1, 0], [-sx, 0, cx]])
    rot_y = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    rot_z = np.array([[0, 0, 1], [cz, sz, 0], [-sz, cz, 0]])
    return np.linalg.inv(rot_z @ rot_x @ rot_y)


def make_grasp(rng, p: dict, cfg: dict) -> dict:
    """One grasp in the loader's layout (every array with a batch axis of
    one)."""
    H, W = p["image_hw"]
    n = cfg["data"]["pointcloud_n"]
    noise = cfg["data"]["pointcloud_noise"]
    kind = p["shapes"][rng.integers(len(p["shapes"]))]
    lo, hi = p["object_half_extent"]
    half = rng.uniform(lo, hi, 3) if kind != "sphere" else np.full(3, rng.uniform(lo, hi))
    R = _rotation(rng)
    centre = rng.uniform(-p["object_offset"], p["object_offset"], 3)

    def place(pts):
        return pts @ R.T + centre

    # the partial scan: the side of the object that faces a seeded view
    view = rng.standard_normal(3)
    view /= np.linalg.norm(view)
    pts, nrm = _surface(kind, half, 4 * n, rng)
    seen = np.nonzero((nrm @ R.T) @ view > -0.2)[0][:n - p["hand_points"]]
    obj_pts = place(pts[seen])
    # the fingers' points: short rods leaving the surface along its normal
    tips, tip_n = _surface(kind, half, 5, rng)
    t = rng.uniform(0.0, p["finger_length"], p["hand_points"])
    f = rng.integers(5, size=p["hand_points"])
    hand = place(tips[f]) + (tip_n[f] @ R.T) * t[:, None] \
        + p["finger_radius"] * rng.standard_normal((p["hand_points"], 3))
    cloud = np.concatenate([obj_pts, hand])
    cloud = cloud[rng.permutation(len(cloud))][:n]
    cloud = cloud + noise * rng.standard_normal(cloud.shape)

    # the world-frame scan of the whole object (norm_pc_1 maps it back)
    w_scale = rng.uniform(*p["world_scale"])
    w_centre = rng.uniform(-0.5, 0.5, 3)
    scan_n, _ = _surface(kind, half, p["scan_points"], rng)
    scan = place(scan_n) * w_scale + w_centre

    # sensors: 1..5 fingers press a dome into the gel; each sensor sits so
    # that the dome's deepest pixel lands on a point of the scan
    n_press = rng.integers(p["fingers_pressing"][0], p["fingers_pressing"][1] + 1)
    touch = np.zeros(5, bool)
    touch[rng.choice(5, n_press, replace=False)] = True
    depth = np.full((5, H, W), DEPTH_REST, np.float32)
    yy, xx = np.mgrid[:H, :W]
    f_px = H / (2 * math.tan(math.radians(CAM_FOV / 2)))
    cam_rot = rng.uniform(-math.pi, math.pi, (5, 3))
    cam_pos = scan[rng.choice(len(scan), 5)].copy()
    for k in range(5):
        if not touch[k]:
            continue
        cy, cx = rng.integers(H // 4, 3 * H // 4), rng.integers(W // 4, 3 * W // 4)
        r = rng.uniform(*p["dome_radius_px"])
        r2 = ((yy - cy) ** 2 + (xx - cx) ** 2) / r ** 2
        dome = np.where(r2 < 1, p["dome_depth"] * (1 - r2), 0.0)
        depth[k] = DEPTH_REST - dome
        z = DEPTH_REST - p["dome_depth"]
        p_cam = np.array([z, -(cx - W / 2) * z / f_px, -(cy - H / 2) * z / f_px])
        rot = cam_rot[k] + np.array(ROT_OFF)
        cam_pos[k] = cam_pos[k] - _cam_rotation(rot) @ p_cam
    imgs = rng.random((5, H, W, 3), dtype=np.float32)
    return {
        "inputs": cloud[None].astype(np.float32),
        "inputs.img": imgs[None],
        "inputs.depth": depth.reshape(1, 5, H * W),
        "inputs.touch_success": touch[None].astype(np.float32),
        "inputs.pc_ply": scan[None].astype(np.float32),
        "points.mano": np.zeros((1, 51), np.float32),
        "points.wrist": (p["wrist_std"] * rng.standard_normal((1, 3))).astype(np.float32),
        "points.cam_pos": cam_pos[None].astype(np.float32),
        "points.cam_rot": cam_rot[None].astype(np.float32),
        "surface_point": place(tips[:1])[0].astype(np.float32),
    }


def seeded(seed: int, stream: int) -> np.random.Generator:
    """NumPy's generator for one stream of draws from a seed of any size
    or sign."""
    seed = int(seed) % (1 << 64)
    return np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, stream])


def make_pool(seed: int, p: dict, cfg: dict) -> list:
    """``p["pool"]`` distinct grasps from ``seed``."""
    rng = seeded(seed, 1)
    return [make_grasp(rng, p, cfg) for _ in range(p["pool"])]


def aim_hands(pool: list, tips_fn, p: dict):
    """Place each grasp's hand so that its fingertips lie on or near its
    object. ``tips_fn(grasps)`` gives the (G, 5, 3) normalized fingertips
    of the grasps as they stand. Each scan is rescaled about its centroid
    so that the tips span ``p["tip_span"]`` of the normalized frame, and the
    ground-truth wrist position (``points.mano[:3]``) is set so that their
    mean lands at the grasp's seeded surface point."""
    tips = tips_fn(pool)
    for g, t in zip(pool, tips):
        ply = g["inputs.pc_ply"][0].astype(np.float64)
        centroid = ply.mean(0)
        scale = 2 * np.sqrt(((ply - centroid) ** 2).sum(1)).max()
        world = t.astype(np.float64) * scale + centroid
        spread = max(np.linalg.norm(a - b) for a in world for b in world)
        new_scale = spread / p["tip_span"]
        g["inputs.pc_ply"] = ((ply - centroid) * (new_scale / scale)
                              + centroid)[None].astype(np.float32)
        # the wrist moves the tips rigidly: shift their mean to the target
        target = g["surface_point"].astype(np.float64)
        g["points.mano"][0, :3] = (target * new_scale - (world.mean(0) - centroid)
                                   ).astype(np.float32)
    return pool


def request_order(seed: int, n_pool: int, n: int) -> np.ndarray:
    """The seeded order in which the pool's grasps are sent: whole
    permutations of the pool, one after another."""
    rng = seeded(seed, 2)
    reps = -(-n // n_pool)
    return np.concatenate([rng.permutation(n_pool) for _ in range(reps)])[:n]
