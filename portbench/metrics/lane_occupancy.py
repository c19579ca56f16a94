"""Column-iterations the engine ran for the window's requests over the
iterations its ticks offered (ticks × slots × iters_per_tick), in
percent (``SolveEngine`` stats and the requests' ``iters``)."""


def read(ctx):
    c = ctx.counters
    offered = c.get("ticks", 0) * c["slots"] * c["iters_per_tick"]
    return 100.0 * c["column_iters"] / offered if offered else None
