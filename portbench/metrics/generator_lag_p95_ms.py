"""95th percentile over the window's requests of how late the benchmark's load generator submitted each request against its due time, in ms."""
from portbench import yardstick


def read(ctx):
    xs = ctx.counters.get("generator_lag_s")
    return 1e3 * yardstick.percentile(xs, 95) if xs else None
