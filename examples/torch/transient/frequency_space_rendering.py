"""Frequency-space (phasor-field) rendering of the Cornell box with the
PyTorch port (the port of examples/transient/frequency_space_rendering.py):
a ``phasor_hdr_film`` in place of the transient film, its amplitude and
phase at one frequency.  The phasor film is monochromatic only.

    python examples/torch/transient/frequency_space_rendering.py [--quick] [--device cpu]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import numpy as np  # noqa: E402

from common import example_args, host, save_image  # noqa: E402

import mitransient_tpu_torch as mt  # noqa: E402
from mitransient_tpu_torch.film.phasor_film import (  # noqa: E402
    phasor_frequencies,
)


def main():
    args = example_args("frequency_space", __doc__)
    res, bins, spp = (24, 512, 16) if args.quick else (200, 4000, 128)
    spp = args.spp or spp

    old = mt.variant().name
    mt.set_variant("mono")
    try:
        d = mt.cornell_box()
        d["sensor"]["film"] = {
            "type": "phasor_hdr_film",
            "width": res, "height": res,
            "temporal_bins": bins,
            "bin_width_opl": d["sensor"]["film"]["bin_width_opl"],
            "start_opl": d["sensor"]["film"]["start_opl"],
            # Morlet wavelet parameters (cbox_diffuse_freq.xml:2-43)
            "wl_mean": 2.0, "wl_sigma": 2.0,
        }
        scene = mt.load_dict(d, device=args.device)
        freqs = phasor_frequencies(scene.sensors[0].film)
        print(f"{len(freqs)} frequencies in the Morlet ±3σ band:", freqs)

        steady, phasors = mt.render(scene, spp=spp, seed=0)
        phasors = host(phasors)  # (H, W, F, 2) real / imaginary
        amp = np.hypot(phasors[..., 0], phasors[..., 1])
        phase = np.arctan2(phasors[..., 1], phasors[..., 0])

        k = len(freqs) // 2
        save_image(os.path.join(args.out, "steady.png"), steady)
        save_image(os.path.join(args.out, f"amplitude_f{k}.png"), amp[..., k])
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        plt.imsave(os.path.join(args.out, f"phase_f{k}.png"), phase[..., k],
                   cmap="twilight")
        print("wrote", args.out)
    finally:
        mt.set_variant(old)


if __name__ == "__main__":
    main()
