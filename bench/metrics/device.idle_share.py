"""Share of the time in which no operation ran on the device: one less the
device's busy seconds a round, from the trace's device pass (the union of
its device events), over the seconds a round takes in the steady part,
which no profiler slows.  A round's device work is the same in both: the
bank runs every slot, occupied or not."""


def read(run):
    if run.trace is None or not run.trace_rounds or not run.steady_rounds:
        return None
    busy = run.trace["busy_s"] / run.trace_rounds
    return 1.0 - busy / (run.steady_s / run.steady_rounds)
