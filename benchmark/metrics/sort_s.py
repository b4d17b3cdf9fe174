"""Seconds per sort: the window, from the first sort's launch until the
last sort is synchronised on every card of the cell, over the sorts it
completed (every gap between sorts inside it)."""


def read(run):
    return run.window_s / run.sorts if run.sorts else None
