"""Share of its bytes bound that ``sample_clique_round`` reaches over the
traced factor call: the graph read once and the final factor written once
(``yardstick.round_bytes``), over 3.35 TB/s, against the kernel's summed
device time in the trace, in percent."""
from portbench import tracing, yardstick


def read(ctx):
    if ctx.summary is None or "traced_bytes" not in ctx.counters:
        return None
    t = tracing.kernel_device_s(ctx.summary, "sample_clique_round",
                                ctx.counters["traced_round_launches"],
                                ctx.notes)
    return yardstick.roofline_pct(ctx.counters["traced_bytes"], t)
