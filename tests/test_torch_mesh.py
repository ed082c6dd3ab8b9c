"""Mesh shapes and the large-mesh path of the port against the JAX package
on the CPU.

- ``mesh``, ``obj`` and ``ply`` scenes load leaf by leaf equal to the JAX
  loader's (integers, bools and the accel tables exactly; other floats
  within 1e-7 of the leaf's max, the rule of test_torch_scene.py).  The
  files are written from the sphere generator; one OBJ is over 1 MiB and
  has no ``vt`` lines, so both packages parse it with the native parser.
- The small sphere config (``small_cbox`` with a 4,512-triangle sphere, so
  the loader builds an accel) renders on the CPU and matches the JAX
  package's render with its accel (shadow rays pipelined) and with the
  accel stripped, under test_golden's rule with no element out.  The ray
  count agrees within 0.1 % with the unpipelined JAX render (a rare
  grazing decision can flip under XLA's FMA contraction, ROADMAP queue 3).
  The pipelined JAX loop also counts the shadow rays that turn out
  occluded (``path_regen.py:258-260`` skips the visibility mask that
  ``ds.pdf`` carries otherwise), so its count is larger by them.
"""
import numpy as np
import pytest
import torch

import mitransient_tpu as mitr
import mitransient_tpu_torch as mt
from test_torch_scene import assert_leaves_equal
from torch_cases import golden_mismatch, small_cbox, small_sphere_cbox, uv_sphere

torch.set_num_threads(1)


def _write_obj(path, verts, faces, uvs=None):
    with open(path, "w") as f:
        f.write("# uv sphere\n")
        f.writelines(f"v {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in verts)
        if uvs is not None:
            f.writelines(f"vt {u:.9g} {v:.9g}\n" for u, v in uvs)
            f.writelines(f"f {a}/{a} {b}/{b} {c}/{c}\n" for a, b, c in faces + 1)
        else:
            f.writelines(f"f {a} {b} {c}\n" for a, b, c in faces + 1)


def _write_ply(path, verts, faces, uvs, binary):
    head = ["ply", "format binary_little_endian 1.0" if binary
            else "format ascii 1.0", f"element vertex {len(verts)}",
            "property float x", "property float y", "property float z",
            "property float u", "property float v",
            f"element face {len(faces)}",
            "property list uchar int vertex_indices", "end_header"]
    rows = np.concatenate([verts, uvs], axis=1).astype(np.float32)
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode())
        if binary:
            f.write(rows.tobytes())
            for tri in faces.astype("<i4"):
                f.write(b"\x03" + tri.tobytes())
        else:
            f.writelines(" ".join(f"{x:.9g}" for x in r).encode() + b"\n"
                         for r in rows)
            f.writelines(f"3 {a} {b} {c}\n".encode() for a, b, c in faces)


def _file_scene(name):
    desc = small_cbox(mt)
    desc["small-box"] = {"type": name.split(".")[-1], "filename": name,
                         "to_world": desc["small-box"]["to_world"],
                         "bsdf": {"type": "ref", "id": "white"}}
    return desc


def test_mesh_scene_leaves_equal_jax():
    desc = small_sphere_cbox(mt)
    jsc, tsc = mitr.load_dict(desc), mt.load_dict(desc, device="cpu")
    assert tsc.data.accel is not None and jsc.data.accel is not None
    assert_leaves_equal(jsc, tsc)


@pytest.mark.parametrize("fmt", ["obj_uv", "obj_big", "ply_ascii",
                                 "ply_binary"])
def test_file_mesh_leaves_equal_jax(tmp_path, fmt):
    rings = 128 if fmt == "obj_big" else 12
    verts, faces = uv_sphere(rings, rings)
    uvs = np.stack([np.arctan2(verts[:, 2], verts[:, 0]), verts[:, 1]], -1)
    name = "sphere." + fmt.split("_")[0]
    if fmt == "obj_uv":
        _write_obj(tmp_path / name, verts, faces, uvs)
    elif fmt == "obj_big":
        _write_obj(tmp_path / name, verts, faces)
        assert (tmp_path / name).stat().st_size > 1 << 20
    else:
        _write_ply(tmp_path / name, verts, faces, uvs,
                   binary=fmt == "ply_binary")
    desc = _file_scene(name)
    jsc = mitr.load_dict(desc, base_dir=str(tmp_path))
    tsc = mt.load_dict(desc, device="cpu", base_dir=str(tmp_path))
    assert tsc.data.tri.v0.shape[0] == len(faces) + 24
    assert (tsc.data.accel is not None) == (fmt == "obj_big")
    assert_leaves_equal(jsc, tsc)


def test_small_sphere_render_matches_jax_with_and_without_accel():
    desc = small_sphere_cbox(mt)
    tsc = mt.load_dict(desc, device="cpu")
    ts, tt, tstats = mt.render(tsc, spp=8, seed=0, return_stats=True)
    ts, tt = ts.numpy(), tt.numpy()
    assert np.isfinite(ts).all() and np.isfinite(tt).all()
    jsc = mitr.load_dict(desc)
    assert jsc.data.accel is not None
    jrays = {}
    for accel in (True, False):
        if not accel:
            jsc.data = jsc.data._replace(accel=None)
        js, jt, jstats = mitr.render(jsc, spp=8, seed=0, return_stats=True)
        for got, want in ((ts, np.asarray(js)), (tt, np.asarray(jt))):
            m = golden_mismatch(got, want)
            assert m["shape_ok"] and m["n_bad"] == 0, (accel, m)
        jrays[accel] = int(np.asarray(jstats["rays"]))
    rays = int(tstats["rays"])
    assert abs(rays - jrays[False]) <= 1e-3 * jrays[False] and rays > 5000
    assert jrays[True] > rays
