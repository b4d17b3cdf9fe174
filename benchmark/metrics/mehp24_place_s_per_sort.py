"""Device seconds per sort that MEHP24 spent placing each value by its
rank (the indicators times the input, and the column sums): the span
mehp24.place of the context's spans (ctx.span_s, CUDA events read at
each sort's synchronisation) over the window.  Nothing to read where
the program has no such span."""

SPAN = "mehp24.place"


def read(run):
    before, after = run.before["ctx"], run.after["ctx"]
    if SPAN not in after.get("span_s", {}) or not run.sorts:
        return None
    return (after["span_s"][SPAN]
            - before["span_s"].get(SPAN, 0.0)) / run.sorts
