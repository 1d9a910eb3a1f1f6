"""The port's native host engines (vtaco_tpu_torch/native: mc.cpp and
geom.cpp, built by g++ at first use) against their plain references and
the JAX package's engines, on the CPU.

- marching cubes: the native extractor equals the port's numpy reference
  as a triangle soup (test_marching_cubes.py's fields, its ``_canon`` at
  1e-5), for 1, 2, 3 and 7 x-slab threads with equal vertex counts, and
  equals the JAX package's native extractor array for array, vertex order
  included (the order the generator's 2048-vertex metric sample draws
  from);
- the KD-tree against scipy's cKDTree, the host winding numbers against
  the port's torch winding numbers, the mesh reader against the Python
  readers (comments inside an OFF body, out-of-range faces);
- the lattice encode against its numpy form: the same nodes bit for bit on
  lattice inputs, residuals within 1e-5 lattice units and the same accept
  or reject at the callers' 1e-3 on points near the lattice, and NaN,
  inf and out-of-range coords rejected;
- a g++ that fails raises, naming the source: no numpy fallback.
"""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from vtaco_tpu import native as jnative
from vtaco_tpu.generate.marching_cubes import marching_cubes as jax_marching_cubes
from vtaco_tpu_torch import native
from vtaco_tpu_torch.generate.generator import Generator3D
from vtaco_tpu_torch.generate.marching_cubes import _marching_cubes_numpy, marching_cubes
from vtaco_tpu_torch.ops.metrics import chamfer_distance, chamfer_distance_kdtree
from vtaco_tpu_torch.ops.winding import winding_number, winding_number_host
from vtaco_tpu_torch.utils import meshio

from test_marching_cubes import _canon, _fields

TOL = 1e-3     # the residual the generator's callers accept


def test_marching_cubes_matches_numpy_and_jax(rng):
    for vol in _fields(rng):
        lvl = float(vol.mean())
        vn, fn = _marching_cubes_numpy(vol, lvl)
        vc, fc = native.mc.marching_cubes(vol, lvl, threads=1)
        assert (len(vc), len(fc)) == (len(vn), len(fn))
        np.testing.assert_allclose(_canon(vc, fc), _canon(vn, fn), atol=1e-5)
        jv, jf = jnative.mc.marching_cubes(vol, lvl, threads=1)
        np.testing.assert_array_equal(vc, jv)
        np.testing.assert_array_equal(fc, jf)
        # the entry point, with its default level and thread rule
        tv, tf = marching_cubes(vol)
        jv, jf = jax_marching_cubes(vol)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tf, jf)


def test_thread_welding(rng):
    for vol in _fields(rng):
        lvl = float(vol.mean())
        v1, f1 = native.mc.marching_cubes(vol, lvl, threads=1)
        for T in (2, 3, 7):
            vt, ft = native.mc.marching_cubes(vol, lvl, threads=T)
            assert (len(vt), len(ft)) == (len(v1), len(f1)), f"threads={T}"
            np.testing.assert_allclose(_canon(vt, ft), _canon(v1, f1), atol=1e-5)


def test_thread_rule_at_128():
    """From 128³ points up the extractor splits x into slabs and welds
    them: the mesh equals the serial one as a soup, with as many vertices
    (a duplicate left on a slab boundary would add one)."""
    x = np.linspace(-1, 1, 128, dtype=np.float32)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    vol = 0.6 - np.sqrt(X ** 2 + Y ** 2 + 1.3 * Z ** 2)
    v, f = marching_cubes(vol, 0.0)
    v1, f1 = native.mc.marching_cubes(vol, 0.0, threads=1)
    assert (len(v), len(f)) == (len(v1), len(f1))
    np.testing.assert_allclose(_canon(v, f[:, ::-1]), _canon(v1, f1), atol=1e-5)


def test_degenerate_volumes():
    v, f = native.mc.marching_cubes(np.full((9, 9, 9), -1.0, np.float32), 0.0, threads=2)
    assert len(v) == 0 and len(f) == 0
    tiny = np.zeros((2, 2, 2), np.float32)
    tiny[1, 1, 1] = 1.0
    v, f = native.mc.marching_cubes(tiny, 0.5, threads=4)
    vn, fn = _marching_cubes_numpy(tiny, 0.5)
    assert (len(v), len(f)) == (len(vn), len(fn))
    with pytest.raises(ValueError, match="3-d volume"):
        native.mc.marching_cubes(np.zeros((4, 4), np.float32), 0.0)


def test_nearest_matches_scipy(rng):
    pts = rng.standard_normal((2000, 3)).astype(np.float32)
    q = rng.standard_normal((500, 3)).astype(np.float32)
    d2, idx = native.geom.nearest(pts, q)
    d_ref, _ = cKDTree(pts).query(q)
    np.testing.assert_allclose(np.sqrt(d2), d_ref, rtol=1e-5, atol=1e-6)
    # indices may differ only on exact ties; distances decide
    np.testing.assert_allclose(np.linalg.norm(pts[idx] - q, axis=1), d_ref,
                               rtol=1e-5, atol=1e-6)


def test_chamfer_kdtree_matches_brute_force(rng):
    a = rng.standard_normal((2, 2048, 3)).astype(np.float32)
    b = rng.standard_normal((2, 2048, 3)).astype(np.float32)
    got = chamfer_distance(torch.as_tensor(a), torch.as_tensor(b), use_kdtree=True)
    want = chamfer_distance(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    c1, c2, i12, i21 = chamfer_distance_kdtree(a, b, give_id=True)
    assert i12.shape == i21.shape == (2, 2048)
    np.testing.assert_allclose(c1, ((a - b[np.arange(2)[:, None], i12]) ** 2).sum(-1)
                               .mean(1), rtol=1e-5)
    np.testing.assert_allclose(c1 + c2, got, rtol=0)


def test_winding_matches_torch(rng):
    verts, faces = meshio.icosphere(2, radius=0.3)
    pts = rng.uniform(-0.5, 0.5, (256, 3)).astype(np.float32)
    w_host = winding_number_host(verts, faces, pts)
    w_torch = winding_number(torch.as_tensor(verts), torch.as_tensor(faces),
                             torch.as_tensor(pts)).numpy()
    np.testing.assert_allclose(w_host, w_torch, atol=1e-5)
    inside = np.linalg.norm(pts, axis=1) < 0.29
    outside = np.linalg.norm(pts, axis=1) > 0.31
    assert np.all(w_host[inside] > 0.5) and np.all(w_host[outside] < 0.5)


def test_mesh_reader_matches_python(tmp_path):
    verts, faces = meshio.icosphere(1, radius=0.7)
    for ext, writer, reader in ((".off", meshio.write_off, meshio.read_off),
                                (".obj", meshio.write_obj, meshio.read_obj)):
        path = str(tmp_path / f"m{ext}")
        writer(path, verts, faces)
        v_n, f_n = native.geom.read_triangle_mesh(path)
        v_p, f_p = reader(path)
        np.testing.assert_allclose(v_n, v_p, atol=1e-6)
        np.testing.assert_array_equal(f_n, f_p)
        v_d, f_d = meshio.read_triangle_mesh(path)        # native by default
        np.testing.assert_array_equal(v_d, v_n)
        v_py, f_py = meshio.read_triangle_mesh(path, native=False)
        np.testing.assert_array_equal(v_py, v_p)
        np.testing.assert_array_equal(f_py, f_p)
    with pytest.raises(FileNotFoundError):
        native.geom.read_triangle_mesh(str(tmp_path / "missing.off"))


def test_off_body_comments_and_bad_faces(tmp_path):
    """Comments are legal anywhere in an OFF body; out-of-range face ids
    are skipped by the winding numbers, not dereferenced."""
    path = str(tmp_path / "c.off")
    with open(path, "w") as f:
        f.write("OFF\n# header comment\n4 2 0\n"
                "# comment inside the vertex block\n"
                "0 0 0\n1 0 0\n# another\n0 1 0\n0 0 1\n"
                "# comment inside the face block\n"
                "3 0 1 2\n3 0 2 3\n")
    v, fc = meshio.read_triangle_mesh(path)
    np.testing.assert_allclose(v, [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], atol=0)
    np.testing.assert_array_equal(fc, [[0, 1, 2], [0, 2, 3]])
    bad = np.array([[0, 1, 99], [0, -1, 2]], np.int32)
    assert np.allclose(winding_number_host(v, bad, np.zeros((3, 3), np.float32)), 0.0)


def _shuffled_lattice(rng, reso, box, count=None):
    """World coords of ``count`` distinct nodes of the (reso+1)³ lattice
    (all of them without ``count``), shuffled, as the generator makes
    them: ``box·(i/reso − 0.5)``."""
    n = (reso + 1) ** 3
    flat = rng.permutation(n) if count is None else rng.choice(n, count, replace=False)
    ii = np.stack(np.unravel_index(flat, (reso + 1,) * 3), axis=1)
    return (box * (ii / reso - 0.5)).astype(np.float32), ii


@pytest.mark.parametrize("reso,count", [(127, None), (512, 1 << 21)])
def test_lattice_encode_bit_for_bit_on_lattices(rng, reso, count):
    """The shuffled 128³ lattice (uint8 nodes) and 2^21 nodes of MISE's
    513³ lattice (int16 nodes)."""
    box = 1.1
    p, ii = _shuffled_lattice(rng, reso, box, count)
    got, resid = Generator3D._lattice_encode_host(p, box, reso, len(p))
    want, resid_np = Generator3D._lattice_encode_numpy(p, box, reso, len(p))
    assert got.dtype == want.dtype == (np.uint8 if reso <= 255 else np.int16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ii.T)
    assert resid <= TOL and abs(resid - resid_np) <= 1e-5


def test_lattice_encode_near_lattice_and_rejections(rng):
    box = 1.1
    for reso in (64, 300):
        base, _ = _shuffled_lattice(rng, reso, box, 4096)
        for scale in (1e-4, 9e-4, 1.1e-3, 0.3):
            # interior nodes moved by up to ``scale`` lattice units
            p = np.clip(base, -0.45 * box, 0.45 * box)
            p = (p + rng.uniform(-scale, scale, p.shape) * box / reso).astype(np.float32)
            got, r = Generator3D._lattice_encode_host(p, box, reso, 5000)
            want, r_np = Generator3D._lattice_encode_numpy(p, box, reso, 5000)
            assert abs(r - r_np) <= 1e-5, (reso, scale, r, r_np)
            if abs(r_np - TOL) > 1e-5:
                assert (r <= TOL) == (r_np <= TOL)
            if r <= TOL:
                np.testing.assert_array_equal(got, want)
        for bad in (np.nan, np.inf, -np.inf, box, -box):
            q = base.copy()
            q[17, 1] = bad
            assert Generator3D._lattice_encode_host(q, box, reso, 4096)[1] >= 1e3
            assert Generator3D._lattice_encode_numpy(q, box, reso, 4096)[1] >= 1e3
    with pytest.raises(ValueError, match="npad"):
        native.geom.lattice_encode(base, box, 300, 10)


@pytest.mark.parametrize("name,cls", [("mc", "_MC"), ("geom", "_Geom")])
def test_failed_build_raises(monkeypatch, tmp_path, name, cls):
    """No quiet fallback: a g++ that fails raises, naming the source."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native.shutil, "which", lambda _: "false")
    with pytest.raises(RuntimeError, match=f"g\\+\\+ failed for native/{name}.cpp"):
        getattr(native, cls)()._ensure()


def test_library_name_hashes_flags_and_tables(monkeypatch):
    """The library's name changes with the compiler flags and, for mc,
    with the tables module its header is generated from."""
    mc, geom = native._digest("mc"), native._digest("geom")
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native._digest("mc") != mc and native._digest("geom") != geom
    monkeypatch.undo()
    tables = native._HEADERS["mc"][0][0]
    monkeypatch.setitem(native._HEADERS, "mc", ((tables, native.__file__),
                                                native._HEADERS["mc"][1]))
    assert native._digest("mc") != mc
