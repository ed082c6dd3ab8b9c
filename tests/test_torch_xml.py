"""The port's Mitsuba XML loader (``mt.load_file``) against the JAX
package's ``mitr.load_file`` on the CPU: tests/test_xml.py's ``CBOX_XML``
and a variant of it with the ported materials and textures.

Loaded leaves equal the JAX loader's (integers and bools exactly, other
floats within 1e-7 of the leaf's max, the rule of test_torch_scene.py);
renders agree under test_golden's rule (rtol 5e-4, atol 5e-5 * max) with
no element out.
"""
import os

import numpy as np
import pytest
import torch

import mitransient_tpu as mitr
import mitransient_tpu_torch as mt
from test_torch_scene import assert_leaves_equal
from test_xml import CBOX_XML
from torch_cases import golden_mismatch

torch.set_num_threads(1)

# CBOX_XML with a two-sided rough gold back wall, a checkered floor with a
# scaled to_uv, a bump-mapped dielectric panel and a relative bitmap that
# does not exist (it loads untextured, as in the JAX package)
MATERIALS_XML = CBOX_XML.replace(
    """    <shape type="rectangle" id="back">
        <transform name="to_world">
            <translate value="0 0 -1"/>
        </transform>
        <ref id="white"/>
    </shape>""",
    """    <shape type="rectangle" id="back">
        <transform name="to_world">
            <translate value="0 0 -1"/>
        </transform>
        <bsdf type="twosided" id="gold">
            <bsdf type="roughconductor">
                <string name="material" value="Au"/>
                <float name="alpha_u" value="0.3"/>
                <float name="alpha_v" value="0.1"/>
            </bsdf>
        </bsdf>
    </shape>
    <shape type="rectangle" id="panel">
        <transform name="to_world">
            <scale value="0.3"/>
            <rotate y="1" angle="20"/>
            <translate value="0.2 -0.5 0.2"/>
        </transform>
        <bsdf type="bumpmap">
            <texture type="checkerboard" name="map">
                <transform name="to_uv"><scale value="4 4 1"/></transform>
            </texture>
            <float name="scale" value="0.05"/>
            <bsdf type="dielectric"><float name="int_ior" value="1.4"/></bsdf>
        </bsdf>
    </shape>
    <shape type="cube" id="box">
        <transform name="to_world">
            <scale value="0.2"/>
            <translate value="-0.4 -0.8 0.1"/>
        </transform>
        <bsdf type="diffuse">
            <texture type="bitmap" name="reflectance">
                <string name="filename" value="no-such-texture.png"/>
            </texture>
        </bsdf>
    </shape>""").replace(
    """    <shape type="rectangle" id="floor">
        <transform name="to_world">
            <rotate x="1" angle="-90"/>
            <translate value="0 -1 0"/>
        </transform>
        <ref id="white"/>
    </shape>""",
    """    <shape type="rectangle" id="floor">
        <transform name="to_world">
            <rotate x="1" angle="-90"/>
            <translate value="0 -1 0"/>
        </transform>
        <bsdf type="diffuse">
            <texture type="checkerboard" name="reflectance">
                <rgb name="color0" value="0.8 0.1 0.1"/>
                <rgb name="color1" value="0.1 0.1 0.8"/>
                <transform name="to_uv"><scale value="3 3 1"/></transform>
            </texture>
        </bsdf>
    </shape>""")


@pytest.fixture(scope="module")
def xml_paths(tmp_path_factory):
    root = tmp_path_factory.mktemp("xml")
    paths = {}
    for name, text in (("cbox", CBOX_XML), ("materials", MATERIALS_XML)):
        paths[name] = str(root / f"{name}.xml")
        with open(paths[name], "w") as f:
            f.write(text)
    return paths


@pytest.mark.parametrize("name", ["cbox", "materials"])
def test_load_file_leaves_and_configs_equal_jax(xml_paths, name):
    jsc = mitr.load_file(xml_paths[name])
    tsc = mt.load_file(xml_paths[name], device="cpu")
    assert_leaves_equal(jsc, tsc)
    assert tsc.sensors[0].film == jsc.sensors[0].film
    for f in tsc.integrator._fields:
        assert getattr(tsc.integrator, f) == getattr(jsc.integrator, f), f
    assert tsc.sensors[0].spp == 8 and tsc.integrator.max_depth == 4
    np.testing.assert_array_equal(tsc.sensors[0].to_world.m,
                                  jsc.sensors[0].to_world.m)
    if name == "materials":
        assert tsc.data.bsdf_kinds == mt.scene.scene.BSDFKinds(
            (0, 2, 3), True)
        assert tsc.data.bsdf.textures.shape[0] == 1
        assert tsc.data.bsdf.bump_textures.shape[0] == 1


@pytest.mark.parametrize("name", ["cbox", "materials"])
def test_load_file_render_matches_jax(xml_paths, name):
    js, jt = mitr.render(mitr.load_file(xml_paths[name]), spp=8, seed=0)
    ts, tt = mt.render(mt.load_file(xml_paths[name], device="cpu"), spp=8,
                       seed=0)
    for got, want in ((ts, js), (tt, jt)):
        m = golden_mismatch(got.numpy(), np.asarray(want))
        assert m["shape_ok"] and m["n_bad"] == 0, m
    prof = tt.numpy().sum(axis=(0, 1, 3))
    assert 4 <= np.nonzero(prof)[0][0] <= 8  # camera -> emitter ~3.84


def test_load_file_overrides_and_transform_order(xml_paths):
    """Keyword arguments override ``<default>``s; XML applies the listed
    transform ops in order (rotate, scale, then translate puts the light
    at y = 0.99)."""
    tsc = mt.load_file(xml_paths["cbox"], device="cpu", res=8, spp=2)
    jsc = mitr.load_file(xml_paths["cbox"], res=8, spp=2)
    assert tsc.sensors[0].film.width == jsc.sensors[0].film.width == 8
    assert tsc.sensors[0].spp == 2
    td = tsc.shapes[tsc.shape_index("light-shape")].triangles()
    center = (td.v0.mean(axis=0) + td.v1.mean(axis=0)
              + td.v2.mean(axis=0)) / 3
    assert abs(center[1] - 0.99) < 1e-4


def test_nlos_capture_type_code_mapping(tmp_path):
    xml = """<scene version="2.1.0">
    <integrator type="transient_nlos_path">
        <integer name="capture_type" value="1"/>
        <boolean name="nlos_laser_sampling" value="true"/>
    </integrator>
    <sensor type="perspective">
        <float name="fov" value="40"/>
        <film type="transient_hdr_film">
            <integer name="width" value="4"/>
            <integer name="height" value="4"/>
        </film>
    </sensor>
    <shape type="rectangle" id="wall"/>
    </scene>
    """
    path = os.path.join(tmp_path, "s.xml")
    with open(path, "w") as f:
        f.write(xml)
    tsc = mt.load_file(path, device="cpu")
    assert tsc.integrator.capture_type == "single"
    assert tsc.integrator.nlos_laser_sampling
    jcfg = mitr.load_file(path).integrator
    for f in tsc.integrator._fields:
        assert getattr(tsc.integrator, f) == getattr(jcfg, f), f


def test_load_file_defaults_to_the_card(xml_paths):
    """Without ``device`` the scene goes to CUDA; where there is none that
    raises rather than building on the CPU."""
    if torch.cuda.is_available():
        assert mt.load_file(xml_paths["cbox"]).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.load_file(xml_paths["cbox"])
