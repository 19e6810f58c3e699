"""Elastic scaling: recompute a valid mesh + batch plan after losing nodes.

A copy of the JAX package's ``repro.runtime.elastic``.  The checkpoint
format is mesh-agnostic (repro_torch.ckpt), and the data pipeline is a pure
function of (seed, step), so elasticity reduces to: pick the largest valid
sub-mesh, place the restored arrays on it, and continue from the
checkpointed step with a rescaled per-host batch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ElasticMeshPlan:
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    global_batch: int
    grad_accum: int  # microbatching to preserve the logical batch size


def plan_elastic(num_devices: int, *, target_model_parallel: int = 16,
                 global_batch: int = 256, multi_pod: bool = False) -> ElasticMeshPlan:
    """Largest (data, model) mesh fitting `num_devices`, preserving the
    logical global batch via gradient accumulation when data shrinks."""
    model = target_model_parallel
    while model > 1 and num_devices % model:
        model //= 2
    data = num_devices // model
    # keep the logical batch: accumulate if the data axis shrank
    full_data = 16 * (2 if multi_pod else 1)
    accum = max(1, int(np.ceil(full_data / max(data, 1))))
    names = ("pod", "data", "model") if multi_pod and data % 2 == 0 and data >= 2 else ("data", "model")
    if len(names) == 3:
        shape = (2, data // 2, model)
    else:
        shape = (data, model)
    return ElasticMeshPlan(shape=shape, axis_names=names,
                           global_batch=global_batch, grad_accum=accum)
