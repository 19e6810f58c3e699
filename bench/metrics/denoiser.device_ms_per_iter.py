"""Device milliseconds of one denoiser call (one a solver iteration), from
the CUDA events the benchmark's wrapper records around each call in the
steady part of a traced run, averaged over the calls."""


def read(run):
    if not run.eps_ms:
        return None
    return sum(run.eps_ms) / len(run.eps_ms)
