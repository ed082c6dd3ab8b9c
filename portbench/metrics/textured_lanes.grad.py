"""Share of the lanes passed to the texture lookup that have a texture:
100 x the program's ``texture.textured`` counter (the lanes whose BSDF
has a texture, ``tid >= 0``) over ``texture.lookups`` (the lanes of each
``bsdf/api.py:_apply_texture`` call that runs eagerly: the two sweeps of
``render_backward`` and a multi-pass pass run before its graph is
captured; a replayed pass counts none, so that its graph holds no
counting work).  The rest take the four taps and their K8 reduction for
nothing (ROADMAP lever 3: looking up the textured lanes only would read
100 %).  None where the program counted neither: a program without the
counters says nothing."""
from harness.spans import counter_share


def read(run):
    return counter_share(run, "texture.textured", "texture.lookups")
