"""Share of the lanes a render cell's bounces launch that hold a live
path: 100 x the program's ``lanes.active`` counter (the lanes of each
bounce that trace a path, ``active.sum()``) over ``lanes.launched`` (the
wavefront's lanes, every bounce of the regen loop and of the multi-pass
``path.py:_bounce``).  The rest run the bounce's launches for nothing:
the tail of the regen loop and the paths that ended before the last
multi-pass bounce (ROADMAP lever 4, lane compaction)."""
from harness.spans import counter_share


def read(run):
    return counter_share(run, "lanes.active", "lanes.launched")
