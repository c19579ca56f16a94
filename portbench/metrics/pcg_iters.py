"""Mean PCG iterations of a column over the window's solves
(``PCGResult.iters``)."""


def read(ctx):
    cols = ctx.counters.get("columns", 0)
    return ctx.counters["column_iters"] / cols if cols else None
