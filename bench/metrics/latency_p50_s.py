"""Median latency, submit to x0 on the host, over every request finished
in the window."""
import numpy as np


def read(run):
    values = [r.latency_s for r in run.requests]
    return float(np.percentile(values, 50)) if values else None
