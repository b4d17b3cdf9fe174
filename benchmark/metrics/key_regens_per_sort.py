"""Rotation keys the key store made (again) per sort in the window."""


def read(run):
    d = run.after["store"]["regen_count"] - run.before["store"]["regen_count"]
    return d / run.sorts if run.sorts else None
