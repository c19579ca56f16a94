"""Idle share of the card over the traced part of a serve cell's window:
the time no kernel, copy or fill ran, in percent of the traced window."""
from portbench.metrics_common import idle_pct


def read(ctx):
    return idle_pct(ctx)
