"""95th percentile over the window's requests of retirement minus lane admission (`finish_time - admit_time`): the engine's ticks, in ms."""
from portbench import yardstick


def read(ctx):
    xs = ctx.counters.get("service_s")
    return 1e3 * yardstick.percentile(xs, 95) if xs else None
