"""95th percentile over the window's requests of lane admission minus due time (`SolveRequest.admit_time`): the wait in the frontend's ingress and the engine's queue, in ms."""
from portbench import yardstick


def read(ctx):
    xs = ctx.counters.get("queue_wait_s")
    return 1e3 * yardstick.percentile(xs, 95) if xs else None
