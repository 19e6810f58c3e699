"""The live bank's wasted share of lane-iterations in the window (from
``SamplingEngine.stepwise_report`` at the window's opening and after its
end): iterations the device ran on vacant lanes or on lanes whose request
had finished."""


def read(run):
    return None if run.bank is None else run.bank["wasted_iter_frac"]
