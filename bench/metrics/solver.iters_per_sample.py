"""Mean ParaTAA iterations (SampleResult.iters) over every request
finished in the window."""


def read(run):
    iters = [r.iters for r in run.requests]
    return sum(iters) / len(iters) if iters else None
