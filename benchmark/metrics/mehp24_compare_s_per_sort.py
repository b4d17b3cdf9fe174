"""Device seconds per sort that MEHP24 spent comparing (replicate,
transpose and the block-pair comparisons): the span mehp24.compare of
the context's spans (ctx.span_s, CUDA events read at each sort's
synchronisation) over the window.  Nothing to read where the program
has no such span."""

SPAN = "mehp24.compare"


def read(run):
    before, after = run.before["ctx"], run.after["ctx"]
    if SPAN not in after.get("span_s", {}) or not run.sorts:
        return None
    return (after["span_s"][SPAN]
            - before["span_s"].get(SPAN, 0.0)) / run.sorts
