"""Key switches per sort in the window: the context's op census of
relinearised products and squares, fused and hoisted rotations."""

KEYSWITCH_OPS = ("mult_relin", "square_relin", "rotate_fused", "fast_rotate")


def read(run):
    before, after = run.before["ctx"]["op_counts"], run.after["ctx"]["op_counts"]
    n = sum(after.get(k, 0) - before.get(k, 0) for k in KEYSWITCH_OPS)
    return n / run.sorts if run.sorts else None
