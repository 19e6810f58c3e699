"""Elastic fault-tolerant serving: the supervision layer around
:class:`~repro_torch.serving.ServingLoop` (the JAX package's
``repro.serving.resilience``, on ``torch.distributed``).

ParaTAA trades extra devices for latency, so one request's solve spans
more hardware than a sequential sampler's would, and inherits a larger
exposure to device loss and stragglers.  This module makes the serving
stack survive mesh shrinkage mid-solve without dropping a ticket:

  * :class:`FaultInjector` — deterministic, injectable device loss for
    chaos tests (``serve.py --chaos-*``): at a chosen supervision round it
    removes ranks from the pool, from the tail, one always surviving.
  * :class:`ResilientServingLoop` — a :class:`ServingLoop` that wraps every
    stepwise round with the :mod:`repro_torch.runtime` control plane: a
    heartbeat per live key per round, straggler round-latency tracking, and
    :class:`~repro_torch.runtime.RestartPolicy` supervision of bank
    failures (backoff between in-place retries, then elastic downsize,
    then abort).
  * On device loss it REBUILDS: every live
    :class:`~repro_torch.sampling.engine.LaneBank` is fetched to the host
    (``SamplingEngine.fetch_bank``, all-gathered over the old mesh's data
    group), the surviving sub-mesh comes from
    :func:`~repro_torch.runtime.plan_elastic`, a fresh engine is built on
    it and the exact state bytes are adopted (``adopt_bank``), so the
    solves resume mid-chunk bit for bit: a lane's math does not depend on
    the data partition.
  * Below ``min_full_quality_devices`` survivors it DEGRADES instead of
    erroring: live lanes fall back to the draft tier (``quality_steps``)
    warm-started from their fetched trajectory.
  * :func:`duplicate_window_eval` — straggler mitigation for ``*-time``
    meshes: a shard's residual reduction computed twice, first finisher
    wins; both compute the same value.

Loss is simulated, as in the JAX package: rank 0's injector decides and
the round header carries the lost ranks to every rank.  The "lost" ranks
stay alive: they take part in the old mesh's last collectives (the fetch)
and in building the survivors' mesh and groups (collective over the
default group), then follow round headers without serving until the
drain ends.

Recovery cost is visible: the ``resilience`` counters (``device_losses``,
``rebuilds``, ``recovered_lanes``, ``recovery_nfe``,
``straggler_duplications``, ``draft_fallbacks``, ``retries``,
``resubmitted_lanes``, ``rebuild_wall_s``, and ``rebuild_bytes``, the
snapshots' bytes a rebuild moved through the host) mirror into the loop's
:mod:`repro_torch.obs` registry.  ``recovery_nfe`` is modeled work: the
chunk a real loss would discard, ``occupied x chunk_iters x window`` eps
evaluations per rebuilt bank.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.launch.mesh import MeshSpec
from repro_torch.obs import StatsView
from repro_torch.runtime import (HeartbeatMonitor, RestartPolicy,
                                 StragglerMitigator, plan_elastic)
from repro_torch.sampling.placement import Placement
from repro_torch.sampling.types import WarmStart
from repro_torch.serving.loop import ServingLoop

__all__ = ["DeviceLossError", "FaultInjector", "ResilientServingLoop",
           "duplicate_window_eval"]


class DeviceLossError(RuntimeError):
    """A device of the serving mesh was lost (simulated by
    :class:`FaultInjector`)."""


class FaultInjector:
    """Deterministic device-loss schedule for chaos tests.

    drop_at: ``{round: count}`` — at supervision round ``round`` (the
             injector's own tick counter, one tick per pump round),
             ``count`` devices are dropped from the END of the current
             pool (the survivors stay a contiguous prefix, which any
             sub-mesh can use).  At least one device always survives.
    """

    def __init__(self, drop_at: Dict[int, int]):
        self.drop_at = dict(drop_at)
        self.round = 0
        self.lost: List = []

    def tick(self, devices: Sequence) -> List:
        """Advance one supervision round; returns the devices newly lost
        THIS round (empty most rounds)."""
        count = self.drop_at.get(self.round, 0)
        self.round += 1
        if not count:
            return []
        alive = [d for d in devices if d not in self.lost]
        count = min(count, max(len(alive) - 1, 0))
        newly = alive[len(alive) - count:] if count else []
        self.lost.extend(newly)
        return newly

    def surviving(self, devices: Sequence) -> List:
        return [d for d in devices if d not in self.lost]


def duplicate_window_eval(engine, bank, shard: int, *, device=None):
    """Straggler mitigation for ``*-time`` meshes: re-run one
    timestep-shard's residual-summary eval on spare capacity (``device``,
    a torch device) and let the first finisher win.

    The duplicated computation is the shard's slice of the per-lane
    residual reduction (rows ``[shard*T/S, (shard+1)*T/S)`` of
    ``R_prev``, this rank's lanes).  Primary and duplicate are the same
    function of the same bytes, so the race is deterministic in value.
    Returns ``(value, winner)``, ``winner`` ``"primary"`` or ``"spare"``;
    raises if the two disagree (a faulty spare)."""
    shards = max(engine.placement.time_shards, 1)
    T = engine.coeffs.T
    lo = shard * T // shards
    hi = max((shard + 1) * T // shards, lo + 1)   # never an empty slice
    rows = bank.state.R_prev[:, lo:hi]            # (lanes, rows, D)

    def reduce_rows(r):
        return torch.amax(torch.abs(r), dim=(1, 2))  # per-lane residual

    primary = reduce_rows(rows)
    primary_np = primary.cpu().numpy()
    if device is None:
        return primary_np, "primary"
    device = torch.device(device)
    spare = reduce_rows(rows.to(device, non_blocking=True))
    winner = "spare"
    if device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        winner = "spare" if done.query() else "primary"
    spare_np = spare.cpu().numpy()
    if not np.array_equal(spare_np, primary_np):
        raise DeviceLossError(
            f"straggler duplicate for shard {shard} disagrees with the "
            f"primary eval — spare device {device} is faulty")
    return (spare_np if winner == "spare" else primary_np), winner


class ResilientServingLoop(ServingLoop):
    """:class:`ServingLoop` with the fault-tolerance control plane wired
    around every stepwise round.

    engine_factory: ``(EngineKey, Placement) -> SamplingEngine`` — how to
              build an engine on any placement; the rebuild calls it with
              the surviving sub-mesh's placement.
    placement: the serving placement whose mesh ranks form the initial
              pool; ``None``/host placement disables fault injection.
    injector: optional :class:`FaultInjector`, ticked once per round (by
              rank 0, which sends the lost ranks in the round header).
    policy / straggler / heartbeat_timeout_s / min_full_quality_devices /
    degrade_quality_steps / clean_rounds_reset / recoverable / clock /
    sleep: as in the JAX package's loop.
    """

    def __init__(self, registry, queue, batcher=None, *,
                 engine_factory: Callable,
                 placement: Optional[Placement] = None,
                 injector: Optional[FaultInjector] = None,
                 policy: Optional[RestartPolicy] = None,
                 straggler: Optional[StragglerMitigator] = None,
                 heartbeat_timeout_s: float = 60.0,
                 min_full_quality_devices: int = 2,
                 degrade_quality_steps: int = 2,
                 clean_rounds_reset: int = 8,
                 recoverable: Optional[Callable[[BaseException], bool]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 **kwargs):
        super().__init__(registry, queue, batcher, **kwargs)
        if not self.chunk_iters:
            raise ValueError(
                "ResilientServingLoop requires chunk_iters > 0: recovery "
                "splices fetched LaneBank state back into live banks "
                "(stepwise mode)")
        self._engine_factory = engine_factory
        self._placement = placement
        self._injector = injector
        self.policy = policy or RestartPolicy()
        self.straggler = straggler or StragglerMitigator()
        self.heartbeat = HeartbeatMonitor((), timeout_s=heartbeat_timeout_s,
                                          clock=clock)
        self.min_full_quality_devices = min_full_quality_devices
        self.degrade_quality_steps = degrade_quality_steps
        self.clean_rounds_reset = clean_rounds_reset
        # RuntimeError covers DeviceLossError and collective failures;
        # ValueError/TypeError (bad requests, shapes) fail fast
        self._recoverable = recoverable or (
            lambda e: isinstance(e, RuntimeError))
        self._clock = clock
        self._sleep = sleep
        self._round = 0
        self._clean_rounds = 0
        self._recovering = False
        self._pool = list(placement.ranks) \
            if placement is not None and placement.is_sharded else []
        self.resilience = StatsView(
            self.obs.metrics, "resilience",
            initial={"device_losses": 0, "rebuilds": 0,
                     "recovered_lanes": 0, "recovery_nfe": 0,
                     "straggler_duplications": 0, "retries": 0,
                     "draft_fallbacks": 0, "resubmitted_lanes": 0,
                     "rebuild_bytes": 0, "rebuild_wall_s": 0.0})

    # -- rank control: loss rides the round header ---------------------------

    def _round_header(self, flush: bool) -> Dict:
        header = super()._round_header(flush)
        if self._injector is not None and self._pool:
            header["lost"] = self._injector.tick(self._pool)
        return header

    def _on_header(self, header: Dict) -> None:
        newly = header.get("lost")
        if not newly:
            return
        if not self.control.leader:
            self._injector.lost.extend(newly)
        self.resilience["device_losses"] += len(newly)
        self._on_device_loss(newly)

    def _serving(self) -> bool:
        return self._placement is None or self._placement.is_member

    def _control_group(self):
        plc = self._placement
        return plc.mesh_group if plc is not None and plc.is_sharded \
            else None

    # -- supervised rounds ---------------------------------------------------

    def _pump_stepwise(self, *, flush: bool = False) -> int:
        t0 = self._clock()
        admitted = super()._pump_stepwise(flush=flush)
        self._after_round(self._clock() - t0)
        return admitted

    def _after_round(self, round_s: float) -> None:
        self._round += 1
        self.straggler.record(round_s)
        for key in list(self._banks):
            self.heartbeat.beat(key, self._round)
        self._clean_rounds += 1
        if self._clean_rounds >= self.clean_rounds_reset \
                and self.policy.restarts:
            self.policy.record_success_window()

    def failed_keys(self):
        """Keys silent past the heartbeat timeout."""
        return self.heartbeat.failed()

    # -- failure supervision (the _fail_bank funnel) --------------------------

    def _fail_bank(self, key, error: BaseException) -> None:
        """Recoverable errors go through the RestartPolicy — in-place retry
        with exponential backoff, then elastic downsize — and only an
        exhausted budget (or an unrecoverable error) fails the bank's
        tickets."""
        if self._recovering or self.error is not None \
                or not self._recoverable(error):
            return super()._fail_bank(key, error)
        action = self.policy.next_action()
        if action == "abort":
            return super()._fail_bank(key, error)
        self.policy.record_restart()
        self._sleep(self.policy.backoff())
        self._clean_rounds = 0
        if action == "restart":
            # in-place retry: keep the bank and its lane tickets
            self.resilience["retries"] += 1
            return
        self._rebuild(self._survivors(), error)

    def _on_device_loss(self, newly_lost: Sequence) -> None:
        """Device loss is never retried in place: rebuild on the
        survivors at once (every rank)."""
        self._clean_rounds = 0
        self._rebuild(self._survivors(), DeviceLossError(
            f"lost {len(newly_lost)} device(s): {list(newly_lost)}"))

    def _survivors(self) -> List:
        if self._injector is not None:
            return self._injector.surviving(self._pool)
        return list(self._pool)

    # -- the rebuild ---------------------------------------------------------

    def _rebuild(self, survivors: List, cause: BaseException) -> None:
        """Fetch every live bank to the host, build the survivors' mesh
        and fresh engines on it, adopt the exact state bytes, resume.
        Every lane's ticket stays open through the rebuild; a bank that
        cannot be migrated resubmits its tickets instead.  An engine
        factory that shards its denoiser (``param_defs``, as
        ``serve.make_engine`` does) re-slices the whole parameter tree
        each rank keeps (the factory's; on the host under ``serve.py
        --mesh``) onto the survivors' mesh: nothing is gathered from the
        lost ranks."""
        if not survivors:
            return self._abort(DeviceLossError(
                f"no surviving devices ({cause})"))
        t0 = self._clock()
        self._recovering = True
        try:
            old = self._placement or Placement.host()
            plan = plan_elastic(
                len(survivors),
                target_model_parallel=max(old.model_shards, 1))
            device_type = old.mesh.device_type if old.is_sharded else "cpu"
            mesh = MeshSpec("elastic", plan.shape, plan.axis_names,
                            "surviving sub-mesh").build(
                                ranks=survivors, device_type=device_type)
            new = Placement.for_mesh(mesh)
            degrade = len(survivors) < self.min_full_quality_devices
            built = list(self.registry.engines())
            if old.is_member:
                for key in list(self._banks):
                    self._migrate_bank(key, new, degrade=degrade)
            # engines without a live bank still sit on the old mesh: swap
            # them too, so their next bank opens on the survivors
            for key in built:
                if key in self._banks:
                    continue
                try:
                    self.registry.replace(key,
                                          self._engine_factory(key, new))
                except Exception:  # noqa: BLE001 — rebuilt lazily below
                    pass
            self._placement = new
            self._pool = list(survivors)
            factory = self._engine_factory
            self.registry.set_factory(lambda k, _plc=new: factory(k, _plc))
            self.resilience["rebuilds"] += 1
        finally:
            self._recovering = False
            self.resilience["rebuild_wall_s"] += self._clock() - t0

    def _migrate_bank(self, key, placement: Placement, *,
                      degrade: bool) -> None:
        old_engine = self.registry.get(key)
        bank = self._banks[key]
        tickets = self._lane_tickets[key]
        try:
            snapshot = old_engine.fetch_bank(bank)
        except Exception:  # noqa: BLE001 — lose progress, never tickets
            return self._resubmit_bank(key, tickets)
        self.resilience["rebuild_bytes"] += snapshot.nbytes()
        if degrade:
            return self._degrade_bank(key, old_engine, snapshot, tickets)
        if not placement.is_member:
            # this rank is not one of the survivors: it holds no lanes
            self._banks.pop(key, None)
            self._lane_tickets.pop(key, None)
            return
        try:
            new_engine = self._engine_factory(key, placement)
            new_bank = new_engine.adopt_bank(snapshot)
        except Exception:  # noqa: BLE001
            return self._resubmit_bank(key, tickets)
        self.registry.replace(key, new_engine)
        self._banks[key] = new_bank
        # adopt_bank keeps lane indexing: the lane -> ticket map carries
        occupied = new_bank.occupied
        self.resilience["recovered_lanes"] += occupied
        # modeled recovery NFE: the chunk in flight a real loss discards
        self.resilience["recovery_nfe"] += \
            occupied * new_bank.chunk_iters * new_engine.window

    def _resubmit_bank(self, key, tickets) -> None:
        """Fallback when state migration is impossible: the bank's open
        tickets re-enter the queue with their requests intact."""
        for lane, ticket in enumerate(tickets):
            if ticket is not None and not ticket.done():
                self.obs.tracer.async_instant("resubmit_recovery",
                                              ticket.seqno, lane=lane)
                self.queue.resubmit(ticket)
                self.resilience["resubmitted_lanes"] += 1
        self._banks.pop(key, None)
        self._lane_tickets.pop(key, None)

    def _degrade_bank(self, key, old_engine, snapshot, tickets) -> None:
        """Graceful degradation: each open ticket resubmits with a
        ``quality_steps`` early-exit budget, warm-started from its fetched
        trajectory, instead of erroring."""
        T = old_engine.coeffs.T
        shape = old_engine.sample_shape
        x = snapshot.state["x"]
        if "x" in snapshot.bf16:
            x = torch.from_numpy(x).view(torch.bfloat16).float().numpy()
        for lane, ticket in enumerate(tickets):
            if ticket is None or ticket.done():
                continue
            request = snapshot.requests[lane] or ticket.request
            traj = np.asarray(x[lane]).reshape((T + 1,) + shape)
            degraded = dataclasses.replace(
                request, init=WarmStart(trajectory=traj),
                quality_steps=self.degrade_quality_steps)
            self.obs.tracer.async_instant("draft_fallback", ticket.seqno,
                                          lane=lane)
            self.queue.resubmit(ticket, degraded)
            self.resilience["draft_fallbacks"] += 1
        self._banks.pop(key, None)
        self._lane_tickets.pop(key, None)

    # -- straggler duplication ------------------------------------------------

    def spare_devices(self) -> List:
        """Pool ranks outside the current serving mesh: the spare
        capacity straggler duplicates run on."""
        if self._placement is None or not self._placement.is_sharded:
            return []
        in_mesh = set(self._placement.ranks)
        return [r for r in self._survivors() if r not in in_mesh]

    def mitigate_stragglers(self, key,
                            shard_latencies: Dict[int, float]) -> List[int]:
        """Duplicate the slowest timestep-shards' evals, one per spare
        rank.  A spare rank's process holds no copy of the bank, so the
        duplicate runs on this rank's own device; each is checked against
        the primary (:func:`duplicate_window_eval`)."""
        spares = self.spare_devices()
        if not spares:
            return []
        shards = self.straggler.duplicate_assignments(
            shard_latencies, len(spares))
        engine = self.registry.get(key)
        bank = self._banks.get(key)
        if not shards or bank is None:
            return []
        for shard in shards:
            duplicate_window_eval(engine, bank, shard, device=engine.device)
            self.resilience["straggler_duplications"] += 1
        return shards
