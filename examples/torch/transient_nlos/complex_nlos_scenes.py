"""A complex NLOS scene with the PyTorch port: the reference's Z in a room,
loaded from its XML file (the port of
examples/transient_nlos/complex_nlos_scenes.py).  The file
(``nlos-z-room.xml``: a 32x32 scan, spp 250,000) belongs to the
reference's example corpus, which this repository does not hold: pass
``--scene``, or set ``MITR_REFERENCE_EXAMPLES`` to the corpus.

    python examples/torch/transient_nlos/complex_nlos_scenes.py --scene nlos-z-room.xml [--quick] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import numpy as np  # noqa: E402

from common import (  # noqa: E402
    example_args,
    host,
    reference_file,
    save_image,
)

import mitransient_tpu_torch as mt  # noqa: E402


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", default=reference_file("transient-nlos",
                                                     "nlos-z-room.xml"))
    args = example_args("complex_nlos", __doc__, parser=p)
    if not args.scene or not os.path.exists(args.scene):
        print(f"scene {args.scene} not found; pass --scene", file=sys.stderr)
        return 1

    spp = args.spp or (256 if args.quick else 250_000)
    scene = mt.load_file(args.scene, device=args.device)
    cfg = scene.sensors[0].film
    print(f"scan {cfg.width}x{cfg.height}, {cfg.temporal_bins} bins")
    # aim the laser at the scan centre when the scene uses a capture meter;
    # a perspective variant aims its projector in the XML
    if any(s.kind == "nlos_capture_meter" for s in scene.sensors):
        mt.nlos.focus_emitter_at_relay_wall_pixel(
            [cfg.width / 2, cfg.height / 2], scene)

    _s, transient = mt.render(scene, spp=spp, seed=0)
    tr = host(transient)
    print(f"transient {tr.shape}, energy {tr.sum():.4f}")
    save_image(os.path.join(args.out, "integrated.png"), tr.sum(axis=2))
    np.save(os.path.join(args.out, "transient.npy"), tr)
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    rc = main()
    if rc:
        sys.exit(rc)
