"""Host wall of the untraced solve calls over their PCG loop iterations
(the most iterations of any column of a call), in ms."""


def read(ctx):
    spans = [s for s in ctx.spans.of("solve.call") if not s.attrs["traced"]]
    iters = sum(s.attrs["iters"] for s in spans)
    if not iters:
        return None
    return 1e3 * sum(s.end - s.start for s in spans) / iters
