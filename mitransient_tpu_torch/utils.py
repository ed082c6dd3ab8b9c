"""User-facing utilities: a copy of ``mitransient_tpu/utils.py``."""
from __future__ import annotations

speed_of_light = 299792458.0
"""Speed of light in meters/second."""


def cornell_box():
    """Transient Cornell box scene dict, the canonical benchmark workload:
    256x256, 300 bins, start_opl 3.5, bin_width_opl 0.02, transient_path
    max_depth 8."""
    return {
        "type": "scene",
        "integrator": {
            "type": "transient_path",
            "camera_unwarp": False,
            "max_depth": 8,
            "temporal_filter": "box",
            "gaussian_stddev": 2.0,
        },
        "sensor": {
            "type": "perspective",
            "fov_axis": "smaller",
            "near_clip": 0.001,
            "far_clip": 100.0,
            "focus_distance": 1000,
            "fov": 39.3077,
            "to_world": {
                "look_at": {
                    "origin": [0, 0, 3.90],
                    "target": [0, 0, 0],
                    "up": [0, 1, 0],
                }
            },
            "sampler": {"type": "independent", "sample_count": 256},
            "film": {
                "type": "transient_hdr_film",
                "width": 256,
                "height": 256,
                "rfilter": {"type": "box"},
                "temporal_bins": 300,
                "start_opl": 3.5,
                "bin_width_opl": 0.02,
            },
        },
        "white": {
            "type": "diffuse",
            "reflectance": {"type": "rgb", "value": [0.885809, 0.698859, 0.666422]},
        },
        "green": {
            "type": "diffuse",
            "reflectance": {"type": "rgb", "value": [0.105421, 0.37798, 0.076425]},
        },
        "red": {
            "type": "diffuse",
            "reflectance": {"type": "rgb", "value": [0.570068, 0.0430135, 0.0443706]},
        },
        "light": {
            "type": "rectangle",
            "to_world": {
                "translate": [0.0, 0.99, 0.01],
                "rotate": {"axis": [1, 0, 0], "angle": 90},
                "scale": [0.23, 0.19, 0.19],
            },
            "bsdf": {"type": "ref", "id": "white"},
            "emitter": {
                "type": "area",
                "radiance": {"type": "rgb", "value": [18.387, 13.9873, 6.75357]},
            },
        },
        "floor": {
            "type": "rectangle",
            "to_world": {
                "translate": [0.0, -1.0, 0.0],
                "rotate": {"axis": [1, 0, 0], "angle": -90},
            },
            "bsdf": {"type": "ref", "id": "white"},
        },
        "ceiling": {
            "type": "rectangle",
            "to_world": {
                "translate": [0.0, 1.0, 0.0],
                "rotate": {"axis": [1, 0, 0], "angle": 90},
            },
            "bsdf": {"type": "ref", "id": "white"},
        },
        "back": {
            "type": "rectangle",
            "to_world": {"translate": [0.0, 0.0, -1.0]},
            "bsdf": {"type": "ref", "id": "white"},
        },
        "green-wall": {
            "type": "rectangle",
            "to_world": {
                "translate": [1.0, 0.0, 0.0],
                "rotate": {"axis": [0, 1, 0], "angle": -90},
            },
            "bsdf": {"type": "ref", "id": "green"},
        },
        "red-wall": {
            "type": "rectangle",
            "to_world": {
                "translate": [-1.0, 0.0, 0.0],
                "rotate": {"axis": [0, 1, 0], "angle": 90},
            },
            "bsdf": {"type": "ref", "id": "red"},
        },
        "small-box": {
            "type": "cube",
            "to_world": {
                "translate": [0.335, -0.7, 0.38],
                "rotate": {"axis": [0, 1, 0], "angle": -17},
                "scale": 0.3,
            },
            "bsdf": {"type": "ref", "id": "white"},
        },
        "large-box": {
            "type": "cube",
            "to_world": {
                "translate": [-0.33, -0.4, -0.28],
                "rotate": {"axis": [0, 1, 0], "angle": 18.25},
                "scale": [0.3, 0.61, 0.3],
            },
            "bsdf": {"type": "ref", "id": "white"},
        },
    }
