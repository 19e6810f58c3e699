"""One run of one cell: set-up, the measured window, the check, the
metrics, and the result line.

``run_cell`` does everything but the look for a card, which ``run.py``
makes before it: tests drive it on the CPU at a small size.

A traced run (``--trace 1``) on the card splits its window in three: the
device pass (``trace_seconds``: the profiler records the device's activity
alone), the host pass (``host_trace_seconds``: the host's operations too,
only to name the idle gaps), and the steady part, from the host pass's end
to the window's, which no profiler slows: the rounds, lane-iterations,
occupancy and denoiser times that the metrics read are taken there.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from bench.harness import check, roofline, serve, traffic, weights
from bench.harness.catalog import Catalog

#: top-level module names that may not be loaded in the measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")

#: the warm-up request's id, one the window never sends
WARM_RID = 2 ** 62


@dataclasses.dataclass
class Request:
    """A finished request of the window, as a metric reader sees it."""
    rid: int
    latency_s: float
    iters: int
    nfe: int


@dataclasses.dataclass
class RunView:
    """What a metric reader (``bench/metrics/<name>.py``, ``read(run)``)
    is given.  Trace fields are None in a run without ``--trace 1``."""
    cell: dict
    conf: dict
    mix: dict
    seconds: float
    setup_s: float
    requests: List[Request]
    device_kind: str
    peaks: Optional[dict]
    flops_per_sample_call: float
    sample_size: int
    history_m: int
    bank: Optional[dict]
    #: the trace's device pass: its summary and its rounds
    trace: Optional[dict] = None
    trace_rounds: int = 0
    #: the steady part of a traced run (module doc): its seconds, rounds,
    #: lane-iterations, each round's occupied share, each eps call's ms
    steady_s: float = 0.0
    steady_rounds: int = 0
    steady_lane_iters: int = 0
    occupancy: Optional[List[float]] = None
    eps_ms: Optional[List[float]] = None

    @property
    def trace_iterations(self) -> int:
        return self.trace_rounds * int(self.mix["chunk_iters"])

    def taa_round_bytes(self, lanes: int) -> int:
        return roofline.taa_round_bytes(lanes, int(self.mix["T"]),
                                        self.sample_size, self.history_m)


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), each compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def _steps(obs) -> List[dict]:
    """The program's ``stepwise.step`` spans so far (a traced run)."""
    return [e for e in obs.tracer.events() if e["name"] == "stepwise.step"]


def run_cell(cat: Catalog, name: str, seed: int, seconds: float,
             trace: bool, device: torch.device, t0: float,
             log: Callable[[str], None]) -> Dict:
    """Runs the cell once; returns the result line's object."""
    from repro_torch.core import ddim_coeffs
    from repro_torch.launch.backend import apply_backend_tune
    from repro_torch.obs import Observability
    from repro_torch.sampling import SampleRequest, get_sampler

    cell = cat.cell(name)
    conf, mix = cat.config(cell["config"]), cat.traffic(cell["traffic"])
    family = conf["family"]
    den = cat.module("denoisers", family)
    ref = cat.module("reference", family)
    flops = cat.module("flops", family)
    wanted = cat.metrics(name, trace)
    cuda = device.type == "cuda"
    if conf["matmul"] == "tf32":
        apply_backend_tune(["--backend-tune"],
                           platform="gpu" if cuda else "other")

    params = weights.draw(den.param_defs(conf), conf["weight_seed"],
                          device, conf["weight_scales"])
    shape = den.sample_shape(conf)
    T = int(mix["T"])
    requests = traffic.Requests(mix, seed, int(conf.get("num_classes", 0)),
                                shape)
    coeffs = ddim_coeffs(T)
    obs = Observability.enabled() if trace else None
    eps = serve.TimedEps(den.make_eps_apply(conf))
    spec = get_sampler(mix["sampler"])
    stack = serve.Stack(eps, params, coeffs, spec,
                        shape, mix, device,
                        noise_fn=lambda req: requests.noise(req.seed),
                        obs=obs)
    stack.warmup(SampleRequest(label=requests.label(WARM_RID),
                               seed=WARM_RID))
    if cuda:
        torch.cuda.synchronize(device)

    def make_request(rid: int):
        return SampleRequest(label=requests.label(rid), seed=rid)

    # a traced run on the card: the device pass over the window's first
    # ``trace_seconds``, the host pass, then the steady part (module doc);
    # without a card the steady part is the whole window
    steady = {}
    marks, passes, device_steps = [], None, []

    def steady_on():
        steady.update(t=time.monotonic(), steps=len(_steps(obs)))
        eps.timing = cuda

    if trace and cuda:
        from bench.harness.trace import Profile
        passes = Profile(host=False), Profile(host=True)
        device_s, host_s = trace_spans(cell, seconds)

        def device_on():
            device_steps.append(len(_steps(obs)))
            passes[0].start()

        def device_off():
            passes[0].stop()
            device_steps.append(len(_steps(obs)))
            passes[1].start()
            return host_s, host_off

        def host_off():
            passes[1].stop()
            steady_on()

        marks = [(0.0, device_on), (device_s, device_off)]
        Profile.warm()
    elif trace:
        marks = [(0.0, steady_on)]
    opened = {}
    if trace:               # the bank's work so far, as the window opens
        marks.insert(0, (0.0, lambda: opened.update(
            bank=stack.bank_report())))
    arrivals = cat.module("arrivals", mix["arrival"]).Arrivals(mix, seed)
    records, begin, start, end = stack.run(
        make_request, arrivals, seconds,
        lead_in_s=float(mix.get("lead_in_s", 0.0)), marks=marks)
    steps = _steps(obs) if trace else []
    steady_s = time.monotonic() - steady["t"] if steady else 0.0
    if cuda:
        torch.cuda.synchronize(device)
    eps.timing = False
    setup_s = begin - t0
    done = [r for r in records
            if r.result is not None and start <= r.done_at <= end]
    failed = [r for r in records if r.ticket.done() and r.result is None]
    log(f"window: {len(records)} sent, {len(done)} finished in "
        f"{seconds} s after a {start - begin} s lead-in, {len(failed)} "
        f"failed; set-up {setup_s} s")
    bank = _window_work(opened.get("bank"), stack.bank_report()) \
        if trace else None
    slots = int(mix["slots"])
    steady_steps = steps[steady["steps"]:] if steady else []
    eps_ms = eps.elapsed_ms() if eps.events else None
    summary = passes[0].summary() if passes else None
    gaps = passes[1].summary() if passes else None
    if steady:
        log(f"steady part: {steady_s} s, {len(steady_steps)} rounds")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    # the program's state goes before the reference runs
    del stack, eps, obs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    checks, correct = _check(cell, conf, ref, params, requests, done,
                             seed, T, device, log)
    correct = correct and bool(done) and not failed
    del params

    view = RunView(
        cell=cell, conf=conf, mix=mix, seconds=seconds, setup_s=setup_s,
        requests=[Request(r.rid, r.ticket.latency_s, r.result.iters,
                          r.result.nfe) for r in done],
        device_kind=torch.cuda.get_device_name(device) if cuda else "cpu",
        peaks=roofline.peaks(torch.cuda.get_device_name(device))
        if cuda else None,
        flops_per_sample_call=flops.per_sample_call(conf),
        sample_size=int(np.prod(shape)), history_m=spec.history_m,
        bank=bank, trace=summary,
        trace_rounds=device_steps[1] - device_steps[0]
        if len(device_steps) == 2 else 0,
        steady_s=steady_s, steady_rounds=len(steady_steps),
        steady_lane_iters=sum(e["args"]["occupied"] * e["args"]["chunk_iters"]
                              for e in steady_steps),
        occupancy=[e["args"]["occupied"] / slots for e in steady_steps]
        or None, eps_ms=eps_ms)
    metrics = {}
    for m in wanted:
        value = cat.reader(m["name"]).read(view)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": view.device_kind, "count": 1,
                   "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(records),
           "failed": len(failed), "metrics": metrics, "device": device_info}
    if summary is not None:
        from bench.harness.trace import short, top
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        ops = sorted(summary["by_op"].items(), key=lambda kv: -kv[1][0])
        out["breakdown"] = {
            "device_ops": top([(short(k), v[0]) for k, v in ops]),
            "idle_gaps": top([(short(k), v) for k, v in
                              (gaps["idle_gaps"] if gaps else [])])}
        log(f"trace: device pass {summary['window_s']} s, "
            f"{summary['device_events']} device and "
            f"{summary['host_events']} host events")
        if gaps and gaps["window_s"] > 0:
            log(f"trace: host pass {gaps['window_s']} s, busy "
                f"{gaps['busy_s']} s under the host's profiler")
    out["checks"] = checks
    return out


def trace_spans(cell: dict, seconds: float):
    """The seconds of the device pass and of the host pass after it: the
    cell's ``trace_seconds`` and ``host_trace_seconds``, the device pass
    cut to leave the host pass room in a short window (never under half
    the window), the host pass to the rest of the window.  The host pass
    counts from its start, after the device pass's profiler has
    stopped."""
    host = float(cell.get("host_trace_seconds", 0.0))
    device = min(float(cell.get("trace_seconds", seconds)),
                 max(seconds - host, seconds / 2))
    return device, max(min(host, seconds - device), 0.0)


def _window_work(before: Optional[dict], after: Optional[dict]):
    """The bank's wasted share of lane-iterations between two of its
    ``stepwise_report``s (``before`` None: the bank opened in the window):
    iterations the device ran on vacant lanes or on finished requests."""
    if after is None:
        return None
    before = before or {"useful_iters": 0, "device_iters": 0}
    capacity = (after["device_iters"] - before["device_iters"]) \
        * after["slots"]
    if capacity <= 0:
        return None
    useful = after["useful_iters"] - before["useful_iters"]
    return {"wasted_iter_frac": 1.0 - useful / capacity}


def _check(cell, conf, ref, params, requests, done, seed, T, device, log):
    """The compared numbers, each beside its limit, and whether all held."""
    spec = cell["check"]
    sample = check.sample_requests(done, seed, int(spec["sample"]))
    if not sample:
        return {}, False
    t_check = time.monotonic()
    xi = torch.stack([requests.noise(r.rid) for r in sample]).to(device)
    labels = torch.tensor([r.result.request.label for r in sample],
                          dtype=torch.long, device=device)
    traj = torch.from_numpy(np.stack(
        [np.asarray(r.result.trajectory, np.float32) for r in sample]
    )).to(device)

    def eps(x, t, y):
        return ref.eps(params, conf, x, t, y)

    want = ref_traj = check.reference(eps, xi, labels, T,
                                      block=int(spec["block"]))
    got = check.numbers(traj, want, check.linear_part(xi, T))
    del ref_traj
    limits = spec["limits"]
    checks = {k: {"value": got[k], "limit": float(limits[k])}
              for k in limits}
    log(f"check: {len(sample)} of {len(done)} requests against the "
        f"reference in {time.monotonic() - t_check} s")
    return checks, all(c["value"] <= c["limit"] for c in checks.values())
