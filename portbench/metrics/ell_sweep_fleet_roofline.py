"""Share of its bytes bound that the level sweeps reach over the traced
solve calls: each apply's two sweeps (``yardstick.sweep_bytes``: live
slots once, the gathered y sectors, row ids, y in and out) times the
applies, over 3.35 TB/s, against the summed device time of the
``ell_spmv_fleet`` library's sweep and lane-grouping kernels, in
percent."""
from portbench import tracing, yardstick


def read(ctx):
    if ctx.summary is None or "apply_bytes" not in ctx.counters:
        return None
    notes = ctx.notes
    launches = ctx.counters["traced_sweep_launches"]
    s1, n1 = ctx.summary.kernel_time("ell_sweep_fleet_kernel")
    s2, n2 = ctx.summary.kernel_time("group_lanes_kernel")
    if n1 + n2 == 0:
        return None
    t = s1 + s2
    if n1 + n2 < launches:
        notes.append(f"trace holds {n1 + n2} of {launches} sweep launches: "
                     f"their device time is the mean of a record times the "
                     f"launches")
        t = t / (n1 + n2) * launches
    return yardstick.roofline_pct(
        ctx.counters["apply_bytes"] * ctx.counters["traced_applies"], t)
