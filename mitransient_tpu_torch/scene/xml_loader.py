"""Mitsuba-XML scene importer -> scene dict -> Scene.

Counterpart of ``mitransient_tpu/scene/xml_loader.py``.  Covers the XML
surface of the reference's example scenes (versions 2.1/3.3): typed
properties
(float/integer/boolean/string/rgb/spectrum/point/vector), ``<transform>``
chains (translate/rotate/scale/lookat/matrix), ``<default>`` +
``$parameter`` substitution, ``<ref id=...>``, nested
bsdf/emitter/sensor/film/sampler/medium/phase children, and shape plugins.

The importer lowers XML to the same dict schema ``load_dict`` consumes, so
both entry points share one code path (mirroring mi.load_file vs
mi.load_dict).
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from ..core.transform import Transform4
from .schema import Scene


def _subst(value: str, defaults: dict) -> str:
    if "$" in value:
        for k, v in defaults.items():
            value = value.replace(f"${k}", str(v))
    return value


def _parse_vec(s: str):
    parts = s.replace(",", " ").split()
    vals = [float(p) for p in parts]
    return vals[0] if len(vals) == 1 else vals


def _parse_transform(elem, defaults) -> dict:
    """XML transform chain -> our transform spec dict.  XML applies ops
    top-to-bottom with each new op pre-composing on the LEFT
    (point first sees the first listed op), which equals our dict spec read
    in reverse order."""
    ops = []
    for child in elem:
        tag = child.tag
        if tag == "translate":
            if "value" in child.attrib:
                v = _parse_vec(_subst(child.get("value"), defaults))
            else:
                v = [float(child.get(a, 0.0)) for a in "xyz"]
            ops.append(("translate", v if isinstance(v, list) else [v] * 3))
        elif tag == "scale":
            if "value" in child.attrib:
                v = _parse_vec(_subst(child.get("value"), defaults))
            else:
                v = [float(child.get(a, 1.0)) for a in "xyz"]
            ops.append(("scale", v))
        elif tag == "rotate":
            axis = [float(child.get(a, 0.0)) for a in "xyz"]
            if axis == [0.0, 0.0, 0.0] and "value" in child.attrib:
                axis = _parse_vec(_subst(child.get("value"), defaults))
            angle = float(_subst(child.get("angle", "0"), defaults))
            ops.append(("rotate", {"axis": axis, "angle": angle}))
        elif tag in ("lookat", "look_at"):
            ops.append(("look_at", {
                "origin": _parse_vec(_subst(child.get("origin"), defaults)),
                "target": _parse_vec(_subst(child.get("target"), defaults)),
                "up": _parse_vec(_subst(child.get("up", "0 1 0"), defaults)),
            }))
        elif tag == "matrix":
            m = _parse_vec(_subst(child.get("value"), defaults))
            ops.append(("matrix", m))
    # XML chains apply first-listed first to the point; our dict spec applies
    # last-listed first (right-multiplication chain), so reverse.
    out = {}
    for i, (op, arg) in enumerate(reversed(ops)):
        key = op if op not in out else f"{op}#{i}"
        out[key] = arg
    return out


# from_spec takes unique keys only; duplicate ops are chained here
def _transform_spec_to_chain(spec: dict):
    t = Transform4()
    for key, arg in spec.items():
        op = key.split("#")[0]
        if op == "look_at":
            t = t.look_at(arg["origin"], arg["target"], arg["up"])
        elif op == "translate":
            t = t.translate(arg)
        elif op == "scale":
            t = t.scale(arg)
        elif op == "rotate":
            t = t.rotate(arg["axis"], arg["angle"])
        elif op == "matrix":
            t = t._chain(np.asarray(arg, np.float64).reshape(4, 4))
    return t


_CAPTURE_TYPES = {0: "confocal", 1: "single", 2: "exhaustive"}


def _element_to_dict(elem, defaults) -> dict:
    # $parameter substitution applies to attributes too (cbox_diffuse.xml:8)
    d: dict = {"type": _subst(elem.get("type", elem.tag), defaults)}
    child_counter = 0
    for child in elem:
        tag = child.tag
        name = child.get("name")
        if tag == "float":
            d[name] = float(_subst(child.get("value"), defaults))
        elif tag == "integer":
            d[name] = int(float(_subst(child.get("value"), defaults)))
        elif tag == "boolean":
            d[name] = _subst(child.get("value"), defaults).lower() == "true"
        elif tag == "string":
            d[name] = _subst(child.get("value"), defaults)
        elif tag in ("rgb", "spectrum", "srgb"):
            d[name] = {"type": "rgb",
                       "value": _parse_vec(_subst(child.get("value"),
                                                  defaults))}
        elif tag in ("point", "vector"):
            if "value" in child.attrib:
                d[name] = _parse_vec(_subst(child.get("value"), defaults))
            else:
                d[name] = [float(child.get(a, 0.0)) for a in "xyz"]
        elif tag == "transform":
            d[name or "to_world"] = _transform_spec_to_chain(
                _parse_transform(child, defaults))
        elif tag == "ref":
            d[f"ref{child_counter}"] = {"type": "ref", "id": child.get("id")}
            child_counter += 1
        elif tag in ("film", "sampler", "rfilter", "phase"):
            # singleton roles keyed by tag (schema reads these exact keys)
            d[tag] = _element_to_dict(child, defaults)
        elif tag in ("bsdf", "emitter", "sensor", "medium", "shape",
                     "integrator", "texture"):
            key = child.get("name") or child.get("id") or f"{tag}{child_counter}"
            child_counter += 1
            sub = _element_to_dict(child, defaults)
            if child.get("id"):
                # ids are referencable from any nesting level
                sub.setdefault("id", child.get("id"))
            d[key] = sub
        # comments / unknown tags are skipped
    # mitransient XML uses integer capture_type codes (nlos-z-simple.xml:38)
    if d.get("type") == "transient_nlos_path" and isinstance(
            d.get("capture_type"), int):
        d["capture_type"] = _CAPTURE_TYPES.get(d["capture_type"], "single")
    return d


def load_file(path: str, device="cuda", **overrides):
    """Entry point mirroring ``mi.load_file`` (keyword args override XML
    ``<default>`` parameters, e.g. ``load_file(p, resx=256)``); the scene
    is loaded onto ``device``, the card unless the caller asks for the
    CPU, as :func:`load_dict` does."""
    tree = ET.parse(path)
    root = tree.getroot()
    if root.tag != "scene":
        raise ValueError("XML root must be <scene>")
    defaults: dict = {}
    for child in root:
        if child.tag == "default":
            defaults[child.get("name")] = child.get("value")
    for k, v in overrides.items():
        defaults[k] = str(v)

    base_dir = os.path.dirname(os.path.abspath(path))

    def absolutize(d):
        for k, v in d.items():
            if isinstance(v, dict):
                absolutize(v)
            elif k == "filename" and isinstance(v, str) and not os.path.isabs(v):
                d[k] = os.path.join(base_dir, v)

    scene_dict: dict = {"type": "scene"}
    counter = 0
    for child in root:
        if child.tag == "default":
            continue
        key = child.get("id") or child.get("name") or f"{child.tag}_{counter}"
        counter += 1
        if child.tag == "integrator":
            scene_dict["integrator"] = _element_to_dict(child, defaults)
        else:
            scene_dict[key] = _element_to_dict(child, defaults)
    absolutize(scene_dict)
    return Scene(scene_dict, device=device, base_dir=base_dir)
