"""Seconds from the process's start to the first measured sort: import,
context and keys, the encrypted input pool and the warm-up sort."""


def read(run):
    return run.setup_s
