"""Host seconds per sort that the context spent encoding plaintexts
(ctx.pt_encode_s) in the window."""


def read(run):
    d = run.after["ctx"]["pt_encode_s"] - run.before["ctx"]["pt_encode_s"]
    return d / run.sorts if run.sorts else None
