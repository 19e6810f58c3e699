"""The TAA round's share of its memory roofline, in percent: the least
bytes of one round (every lane's (m, T, D) histories and (T, D) sheets
read or written once, harness/roofline.py) over the card's HBM bandwidth,
divided by the device time a round of the kernels of
``kernels/csrc/taa_update.cu`` took in the trace's device pass
(found by name: the staged round's Gram and apply kernels, or the fused
round's kernel), over the solver iterations launched there.
Nothing when the trace holds none of them."""
import re

KERNELS = re.compile(r"\b(gram_kernel|apply_kernel|round_kernel)\s*<")


def read(run):
    if run.trace is None or run.peaks is None or not run.trace_iterations:
        return None
    seconds = sum(s for name, (s, _) in run.trace["by_op"].items()
                  if KERNELS.search(name))
    if seconds <= 0:
        return None
    per_round = seconds / run.trace_iterations
    least = run.taa_round_bytes(int(run.mix["slots"])) \
        / run.peaks["hbm_bytes_per_s"]
    return 100.0 * least / per_round
