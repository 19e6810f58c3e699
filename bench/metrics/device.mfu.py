"""The whole step's share of the card's peak: the model FLOPs of the
denoiser evaluations the requests' own iterations needed in the steady
part of a traced run (its rounds' occupied lanes, each lane-iteration a
window of w evaluations of one sample, priced by the configuration's
frozen formula), over the steady part's seconds times the peak of the
configuration's matmul precision.  Evaluations on vacant lanes count for
nothing."""


def read(run):
    if run.peaks is None or not run.requests or not run.steady_lane_iters \
            or run.steady_s <= 0:
        return None
    w = run.requests[0].nfe / run.requests[0].iters
    flops = run.steady_lane_iters * w * run.flops_per_sample_call
    peak = run.peaks[f"{run.conf['matmul']}_flops_per_s"]
    return flops / (run.steady_s * peak)
