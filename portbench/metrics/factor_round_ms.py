"""Host wall of a factor call over its rounds (``sample_clique_round``
launches, every strict attempt's), over the window's untraced calls, in
ms: the wavefront engine's cost per round."""


def read(ctx):
    rounds = ctx.counters.get("untraced_rounds", 0)
    if not rounds:
        return None
    return 1e3 * ctx.counters["untraced_s"] / rounds
