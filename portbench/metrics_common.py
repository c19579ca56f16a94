"""Arithmetic shared by several per-layer metric readers."""


def idle_pct(ctx):
    """Idle share of the traced window in percent; None without a trace
    or without device activity in it."""
    s = ctx.summary
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
