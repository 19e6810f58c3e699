"""Samples finished in the window over the window's seconds."""


def read(run):
    return len(run.requests) / run.seconds
