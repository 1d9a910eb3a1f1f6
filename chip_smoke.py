"""Smoke run of the PyTorch port (vtaco_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root of a checkout. Phases, each printed as it
ends:
  1. device: the card's name and power limit (nvidia-smi), the torch and
     CUDA versions; TF32 is turned off for matmuls and cuDNN, since the JAX
     reference computes in IEEE float32.
  2. build: nvcc compiles every CUDA source of the package (in parallel).
  3. kernels: each CUDA kernel against its plain PyTorch version at the
     flagship shapes (N = 128^3 query points, C = hidden = 32, 5 blocks,
     K = 128 contacts per finger), max abs error <= 1e-4, then its time
     (CUDA events, after warm-up, cycling three distinct input sets) beside
     its bound and the plain version's time.
  4. main path: VTacO_YCB at full width with random weights from a seed,
     Generator3D.generate_obj_mesh_wnf at nx = 128 on a synthetic batch,
     contact-gated (kernel K1) and ungated (kernel K2), three warm meshes
     each (median time); launch counters are zeroed just before these
     runs and must be positive after them. Then a breakdown of a mesh by
     stage (median of three), and the dense logits of each mode held
     against the plain PyTorch trunk on the same inputs.
Then one JSON line describing the kernels, and last the line
{"ok": true, "device": {...}}. Any failed check raises: the script exits
non-zero and prints no such line. It needs CUDA and the rest of the
repository; it never falls back to the CPU.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from vtaco_tpu_torch.core.config import get_generator, get_model, load_config
from vtaco_tpu_torch.generate.marching_cubes import marching_cubes
from vtaco_tpu_torch.ops import fast_trunk as FT
from vtaco_tpu_torch.ops import metrics
from vtaco_tpu_torch.ops.cuda import build
from vtaco_tpu_torch.ops.cuda import decode as K
from vtaco_tpu_torch.ops.dense_decode import dense_feature_volume_cn, dense_query_grid_cn

REPO = os.path.dirname(os.path.abspath(__file__))
ATOL = 1e-4
RADIUS = 0.015           # contact gating radius (generator default)
NEAR = 1e-6              # |d2 - r^2| below which a gate decision may round either way
N_FLAGSHIP = 128 ** 3    # resolution_0 32 -> nx 128
WIDTH, N_BLOCKS, K_CONTACTS = 32, 5, 128
MESH_REPS = 3            # warm meshes per mode; times are their median
DEVICE_STAGES = ("encode_s", "gates_s", "dense_features_s", "trunk_s", "transfer_s")

# NVIDIA H100 data sheet, dense rates: float32 on the CUDA cores (an FMA is
# two operations) and HBM bandwidth, by the product name the driver reports.
PEAKS = {"PCIe": (51e12, 2.0e12), "NVL": (60e12, 3.9e12), "SXM": (67e12, 3.35e12)}


def log(phase, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


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
    """(operations, bytes) the trunk needs on these inputs: two per
    multiply-add of every layer; with gating, 8 per distance test the data
    needs (up to a finger's first hit) and one add of h per gated point.
    Bytes: coords, features (and c_img rows) read once, logits written."""
    h = c = WIDTH
    in_dim = 3 + (c if c_img else 0)
    flops = 2 * N * (in_dim * h + N_BLOCKS * (c * h + 2 * h * h) + h)
    if with_gate:
        flops += 8 * tests + h * gated
    rows = 3 + c + (c if c_img else 0)
    return flops, N * rows * store_bytes + 4 * N


def gate_stats(p, q, valid, radius, chunk=1 << 18):
    """Distance tests the kernel's loop needs (each finger tests its valid
    contacts only, and stops at its first hit), points gated, and the mask
    of points farther than NEAR from the radius for every valid contact."""
    n_f, k, _ = q.shape
    upto = valid.long().cumsum(1)        # valid rows up to each row, per finger
    tests = gated = 0
    keep = []
    for s in range(0, p.shape[1], chunk):
        d2 = FT.contact_sq_dist(p[:, s:s + chunk], q, valid)
        hit = (d2 < radius * radius).reshape(n_f, k, -1)
        any_f = hit.any(1)
        first = torch.gather(upto, 1, hit.to(torch.uint8).argmax(1))
        tests += int(torch.where(any_f, first, upto[:, -1:]).sum())
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
    """K2 and K1 against their plain versions, then timed."""
    f32_rate, bw = peak
    dec = random_decoder(dev, seed=0)
    tp = FT.extract_trunk_params(dec, with_img=False)
    tpi = FT.extract_trunk_params(dec, with_img=True)
    N = N_FLAGSHIP
    g = torch.Generator(device=dev).manual_seed(1)
    sets = [((torch.rand((3, N), generator=g, device=dev) * 1.1 - 0.55),
             torch.randn((WIDTH, N), generator=g, device=dev)) for _ in range(3)]
    p, f = sets[0]
    rows = {}
    with torch.no_grad():
        # K2: coords only (the main path), c_img rows, bf16 storage, odd N
        err = max_err(K.fused_trunk_cn(tp, p, f), FT.trunk_cn(tp, p, f))
        ci = torch.randn((WIDTH, N), generator=g, device=dev)
        e_img = max_err(K.fused_trunk_cn(tpi, p, f, ci), FT.trunk_cn(tpi, p, f, ci))
        bf = torch.bfloat16
        e_bf = max_err(K.fused_trunk_cn(tp, p, f, store_dtype=bf),
                       FT.trunk_cn(tp, K._stored(p, bf), K._stored(f, bf)))
        n_odd = 1_000_003
        e_odd = max_err(K.fused_trunk_cn(tp, p[:, :n_odd], f[:, :n_odd]),
                        FT.trunk_cn(tp, p[:, :n_odd], f[:, :n_odd]))
        log("kernels", kernel="fused_trunk_cn", N=N, err=err, err_c_img=e_img,
            err_bf16=e_bf, err_odd_N=e_odd, n_odd=n_odd)
        ms = cuda_ms(lambda a, b: K.fused_trunk_cn(tp, a, b), sets, 30)
        plain_ms = cuda_ms(lambda a, b: FT.trunk_cn(tp, a, b), sets, 6)
        flops, nbytes = trunk_work(N, False)
        bound = max(flops / f32_rate, nbytes / bw) * 1e3
        rows["fused_trunk_cn"] = dict(
            err=max(err, e_img, e_bf, e_odd), ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by="operations" if flops / f32_rate > nbytes / bw
            else "bytes", flops=flops, bytes=nbytes)
        log("kernels", kernel="fused_trunk_cn", ms=ms, plain_ms=plain_ms,
            bound_ms=bound, gflop=flops / 1e9, mb=nbytes / 1e6)

        # K1: spread contacts with invalid rows, clustered, all invalid,
        # bf16 storage, odd N
        cs = contact_sets(dev, seed=2)
        cases = [(name, N, None, c) for name, c in cs.items()]
        cases += [("bf16", N, bf, cs["clustered"]),
                  ("odd_N", n_odd, None, cs["invalid_rows"])]
        errs, gated = {}, {}
        for case, n, store, (q, feat, valid) in cases:
            pn, fn = p[:, :n], f[:, :n]
            want = plain_gated(tpi, pn, fn, q, feat, valid, RADIUS, store=store)
            got = K.fused_trunk_gated_cn(tpi, pn, fn, q, feat, valid,
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
        if min(gated["clustered"], gated["invalid_rows"]) * 1000 < N:
            raise AssertionError(f"the contact sets gate too few points: {gated}")

        # timed on the spread contacts: every point tests all 5 fingers
        q, feat, valid = cs["invalid_rows"]
        ms = cuda_ms(lambda a, b: K.fused_trunk_gated_cn(
            tpi, a, b, q, feat, valid, radius=RADIUS), sets, 30)
        plain_ms = cuda_ms(lambda a, b: plain_gated(
            tpi, a, b, q, feat, valid, RADIUS), sets, 3)
        tests, gated, _ = gate_stats(p, q, valid, RADIUS)
        flops, nbytes = trunk_work(N, True, tests=tests, gated=gated)
        bound = max(flops / f32_rate, nbytes / bw) * 1e3
        rows["fused_trunk_gated_cn"] = dict(
            err=max(v[0] for v in errs.values()), ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by="operations" if flops / f32_rate > nbytes / bw
            else "bytes", flops=flops, bytes=nbytes)
        log("kernels", kernel="fused_trunk_gated_cn", ms=ms, plain_ms=plain_ms,
            bound_ms=bound, gflop=flops / 1e9, mb=nbytes / 1e6,
            distance_tests=tests, gated_points=gated)
    return rows


def make_batch(rng, cfg):
    """A B=1 batch in the JAX loader's layout: an ellipsoid object cloud of
    pointcloud_n points (with the config's noise), five 320x240 tactile
    images, depth maps where each finger presses a blob of pixels below the
    gel's rest depth, touch flags (finger 2 not touching), and camera
    poses on a world-frame scan of the object."""
    H, W = 320, 240
    axes = np.array([0.35, 0.25, 0.3])

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


def main_path_phase(dev):
    cfg = load_config(os.path.join(REPO, "configs/VTacO/VTacO_YCB.yaml"),
                      os.path.join(REPO, "configs/default.yaml"))
    model = get_model(cfg)
    randomize(model, seed=0)
    batch = make_batch(np.random.default_rng(0), cfg)
    gens = {"contact": get_generator(model, cfg)}
    cfg_none = json.loads(json.dumps(cfg))
    cfg_none["model"]["with_img"] = False
    gens["none"] = get_generator(model, cfg_none)
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
    def get(key, dtype=torch.float32):
        return torch.as_tensor(batch[key], dtype=dtype, device=dev)

    def stages(gen):
        t = {}

        def mark(name, t0):
            torch.cuda.synchronize()
            t[name] = time.perf_counter() - t0
            return time.perf_counter()

        t0 = time.perf_counter()
        c = model.encode_inputs(get("inputs"))
        t0 = mark("encode_s", t0)
        gates = gen._build_gates(
            model, get("inputs.img"), get("inputs.depth"),
            get("inputs.touch_success") > 0.5, get("inputs.pc_ply"),
            get("points.cam_pos"), get("points.cam_rot"))
        t0 = mark("gates_s", t0)
        box = 1 + gen.padding
        feats = dense_feature_volume_cn(c, nx, box, gen.padding)
        p_cn = dense_query_grid_cn(nx, box, device=dev)
        t0 = mark("dense_features_s", t0)
        tp = FT.extract_trunk_params(model.decoder, with_img=gates[0] != "none")
        logits = gen._trunk_fast(tp, p_cn, feats, *gates[1:], gates[0],
                                 torch.float32, False)
        t0 = mark("trunk_s", t0)
        host = logits.reshape(nx, nx, nx).permute(2, 1, 0).cpu().numpy()
        t0 = mark("transfer_s", t0)
        verts, _ = marching_cubes(host)
        t0 = mark("marching_cubes_s", t0)
        verts = (verts - nx / 2) * box / nx   # as the generator scales them
        np.random.seed(0)                       # and subsamples them
        np.random.shuffle(verts)
        sample = np.ascontiguousarray(verts[:2048])
        metrics.chamfer_distance(get("points.points_obj"),
                                 torch.as_tensor(sample, device=dev)[None])
        t0 = mark("chamfer_s", t0)
        metrics.earth_mover_distance(batch["points.points_obj"][0], sample)
        mark("emd_s", t0)
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is visible", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    variant, peak = peaks(name)
    log("device", name=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda, peak_row=variant,
        f32_tflops=peak[0] / 1e12, hbm_tbs=peak[1] / 1e12,
        tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
        tf32_cudnn=torch.backends.cudnn.allow_tf32)

    t0 = time.perf_counter()
    reports = build.build_all()
    log("build", seconds=round(time.perf_counter() - t0, 3), built=sorted(reports))
    for src, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {src}] {line.strip()}")

    rows = kernel_phase(dev, peak)
    launches = main_path_phase(dev)
    replaced = {   # the pallas_call each kernel replaces
        "fused_trunk_cn": "vtaco_tpu/ops/pallas/decode.py:522",
        "fused_trunk_gated_cn": "vtaco_tpu/ops/pallas/decode.py:641",
    }
    kernels = []
    for kname, replaces in replaced.items():
        r = rows[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "vtaco_tpu_torch/csrc/trunk.cu", "replaces": replaces,
            "launches": launches[kname], "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
        })
    log("done", seconds=round(time.perf_counter() - t_start, 3))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
