"""The plain reference agrees with ``mitransient_tpu_torch`` on the CPU at
a tiny size of each entry, and imports neither the port nor JAX."""
import copy
import subprocess
import sys

import pytest
import torch

import mitransient_tpu_torch as mt
from harness import spec
from reference import tracer
from reference.scene import RefScene

SEED = 2**31 + 77  # larger than a signed 32-bit seed


def _cbox(w=16, h=16):
    desc = copy.deepcopy(spec.load_json(
        spec.BENCH_DIR / "configs" / "cbox.json")["scene"])
    desc["sensor"]["film"].update(width=w, height=h)
    return desc


def _dims(ref):
    return dict(width=ref.width, height=ref.height, bins=ref.bins,
                start_opl=ref.start_opl, bin_width=ref.bin_width,
                max_depth=ref.max_depth, rr_depth=ref.rr_depth)


def _rel(a, b):
    return float((a - b).abs().sum() / b.abs().sum())


@pytest.mark.parametrize("regenerate", [True, False])
def test_cbox_render(regenerate):
    desc = _cbox()
    scene = mt.load_dict(copy.deepcopy(desc), device="cpu")
    st, tr = mt.render(scene, spp=16, seed=SEED, regenerate=regenerate)
    ref = RefScene(desc)
    S = ref.to("cpu")
    pix = torch.tensor([0, 5, 77, 130, 200, 255])
    fn = tracer.render_regen if regenerate else tracer.render_multipass
    rs, rt = fn(S, _dims(ref), SEED, 16, pix)
    assert _rel(st.reshape(256, 3)[pix], rs) < 1e-5
    assert _rel(tr.reshape(256, ref.bins, 3)[pix], rt) < 1e-5
    assert float(rt.sum()) > 0


def test_nlos_capture():
    desc = spec.load_json(
        spec.BENCH_DIR / "tests" / "nlos_scene.json")["scene"]
    film = desc["relay_wall"]["nlos_sensor"]["film"]
    film.update(width=8, height=8)
    scene = mt.load_dict(copy.deepcopy(desc), device="cpu")
    mt.nlos.focus_emitter_at_relay_wall_pixel([4, 4], scene)
    st, tr = mt.render(scene, spp=32, seed=SEED)
    ref = RefScene(desc, focus_pixel=[4, 4])
    rs, rt = tracer.render_nlos(ref.to("cpu"), _dims(ref), SEED, 32,
                                torch.arange(64))
    assert _rel(st.reshape(64, 3), rs) < 1e-5
    assert _rel(tr.reshape(64, ref.bins, 3), rt) < 1e-5
    assert float(rt.sum()) > 0


def test_prb_gradient():
    desc = _cbox()
    scene = mt.load_dict(copy.deepcopy(desc), device="cpu")
    _s, target = mt.render(scene, spp=8, seed=1)
    _s, img = mt.render(scene, spp=8, seed=2, regenerate=False)
    adj = 2.0 / img.numel() * (img - 1.1 * target)
    grads = mt.render_backward(scene, (None, adj), spp=8, seed=SEED)
    ref = RefScene(desc)
    names = sorted(set(ref.bsdf_name.tolist()))
    rows = torch.as_tensor([names.index(b) for b in ref.bsdf_name])
    g, mass = tracer.prb_gradient(ref.to("cpu"), _dims(ref), SEED, 8,
                                  adj.reshape(256, ref.bins, 3), rows)
    assert bool((mass >= g.abs()).all())
    for name in ("white", "red", "green"):
        mine = grads[f"{name}.reflectance.value"].double()
        theirs = g[names.index(name)]
        assert float((mine - theirs).norm()) < 1e-4 * float(theirs.norm())


def test_reference_imports_neither_the_port_nor_jax():
    code = ("import sys; sys.path.insert(0, 'portbench'); "
            "import reference.tracer, reference.scene, reference.streams; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(spec.ROOT), check=True).stdout
    top = set(eval(out))
    assert not top & {"mitransient_tpu_torch", "mitransient_tpu", "jax",
                      "jaxlib", "flax"}
