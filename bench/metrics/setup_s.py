"""Seconds from the process's start to the traffic's: imports, weights,
the engine and one warm-up solve (and, in a fresh checkout, the kernels'
build).  A mix's lead-in, in which the traffic fills the system before
the window opens, is not set-up."""


def read(run):
    return run.setup_s
