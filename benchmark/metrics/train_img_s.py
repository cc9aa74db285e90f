"""Source images trained per second over the whole window: the images of
every step over the window's wall time, the clock stopped on a value that
depends on the last step."""

from benchmark.harness import stats

UNIT = "img/s"


def read(rec):
    return stats.rate(rec.images_per_step * rec.steps, rec.wall_s)
