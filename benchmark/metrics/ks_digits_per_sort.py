"""Key-switch digits per sort in the window: the context's count of the
digits that went through a key inner product and ModDown (ctx.ks_digits,
one per digit of every key switch, hoisted rotations included).  Nothing
to read where the program keeps no such count."""


def read(run):
    before, after = run.before["ctx"], run.after["ctx"]
    if "ks_digits" not in after or not run.sorts:
        return None
    return (after["ks_digits"] - before["ks_digits"]) / run.sorts
