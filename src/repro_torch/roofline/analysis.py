"""Three-term roofline on one NVIDIA H100 SXM (the JAX package's
``repro.roofline.analysis`` with the card's constants):

    compute    = FLOPs            / peak FLOP/s of their type
    memory     = bytes accessed   / HBM bandwidth
    collective = collective bytes / link bandwidth

The FLOPs and bytes come from :class:`repro_torch.roofline.counter.
CostCounter` (an eager program's ops; the reference reads them from a
compiled XLA program).  The collective bytes come from the port's
collective call sites (``repro_torch.comm`` counts each kind's operand
bytes as it issues it): :func:`collective_bytes` stands where the
reference's ``parse_collective_bytes`` reads partitioned HLO, which eager
PyTorch does not have.  On one rank without a mesh nothing is issued and
the term is 0.

The collective term prices each group's bytes at the slowest link its
ranks cross (:func:`link_bytes`), the H100 form of the reference's single
ICI constant: NVLink inside a node, the network between nodes.  A node is
8 consecutive ranks (an HGX H100 board: 8 cards on NVLink 4 through
NVSwitch), so a mesh axis whose group spans more than one block of 8
ranks is priced at the network's rate.  Modeled, not measured: no
collective across cards has been timed.

Hardware constants: NVIDIA H100 SXM5 data sheet, dense rates without
sparsity, at its 700 W limit — 989 TFLOP/s bf16 on the tensor cores, 495
TFLOP/s TF32, 67 TFLOP/s float32 outside the tensor cores; 80 GB of HBM3
at 3.35 TB/s; NVLink 4, 900 GB/s a card to its peers, 450 GB/s each way.
Between nodes: one 400 Gb/s NDR InfiniBand port a GPU (ConnectX-7, the
HGX H100 reference design's one NIC per GPU), 50 GB/s each way.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Optional

PEAK_FLOPS = 989e12     # bf16 (and fp16) tensor cores, dense, per card
TF32_FLOPS = 495e12     # TF32 tensor cores, dense
F32_FLOPS = 67e12       # float32 outside the tensor cores
HBM_BW = 3.35e12        # bytes/s, HBM3
LINK_BW = 450e9         # bytes/s, NVLink 4, each way
NETWORK_BW = 50e9       # bytes/s, one 400 Gb/s NDR InfiniBand port a GPU
RANKS_PER_NODE = 8      # cards on one NVLink domain (an HGX H100 node)
HBM_PER_CHIP = 80e9     # bytes of HBM3

#: bytes/s each way of a link tier
LINK_TIERS = {"nvlink": LINK_BW, "network": NETWORK_BW}


#: the collective kinds of the reference's HLO parser, in its order
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def collective_bytes(counted: Optional[Mapping[str, int]] = None
                     ) -> Dict[str, int]:
    """Per-collective-kind operand bytes a rank issued, under the
    reference's kind names (its ``parse_collective_bytes`` result):
    ``counted`` defaults to ``repro_torch.comm.nbytes``, the counts since
    its last ``reset``.  Kinds the port never issues stay 0."""
    if counted is None:
        from repro_torch import comm

        counted = comm.nbytes
    return {k: int(counted.get(k, 0)) for k in COLLECTIVES}


def link_of(ranks: Iterable[int]) -> str:
    """The slowest link a group of global ranks crosses: ``nvlink`` when
    they sit in one node of :data:`RANKS_PER_NODE` consecutive ranks,
    else ``network``."""
    return "nvlink" if len({int(r) // RANKS_PER_NODE for r in ranks}) <= 1 \
        else "network"


def link_bytes(group_bytes: Optional[Mapping] = None) -> Dict[str, int]:
    """Collective bytes by the link tier they cross: ``group_bytes``
    (default ``repro_torch.comm.group_bytes``: (kind, group's ranks) ->
    bytes) summed by :func:`link_of` of each group."""
    if group_bytes is None:
        from repro_torch import comm

        group_bytes = comm.group_bytes
    out = dict.fromkeys(LINK_TIERS, 0)
    for (_, ranks), n in group_bytes.items():
        out[link_of(ranks)] += int(n)
    return out


def peak_for(dtype: str, tf32: bool = False) -> float:
    """The card's peak FLOP/s for products of ``dtype`` operands: float32
    at the TF32 rate when TF32 is on, else outside the tensor cores."""
    if dtype == "float32":
        return TF32_FLOPS if tf32 else F32_FLOPS
    return PEAK_FLOPS


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_lb(self) -> float:
        """Lower-bound step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """dominant / sum of the terms (1.0: the dominant resource is the
        only cost under perfect overlap)."""
        s = self.compute_s + self.memory_s + self.collective_s
        return self.step_time_lb / s if s else 0.0


def roofline_terms(flops_per_chip: float, bytes_per_chip: float,
                   coll_bytes_per_chip: float, *,
                   flops_by_dtype: Optional[Dict[str, float]] = None,
                   tf32: bool = False,
                   by_link: Optional[Mapping[str, float]] = None
                   ) -> RooflineTerms:
    """The three terms.  With ``flops_by_dtype`` (the counter's split) each
    dtype's FLOPs take their own peak (:func:`peak_for`); without it all
    FLOPs take the bf16 peak, as the reference's do.  With ``by_link``
    (:func:`link_bytes`) each tier's bytes take its own rate; without it
    every collective byte takes NVLink's."""
    if flops_by_dtype:
        compute_s = sum(f / peak_for(d, tf32)
                        for d, f in flops_by_dtype.items())
    else:
        compute_s = flops_per_chip / PEAK_FLOPS
    return RooflineTerms(
        compute_s=compute_s,
        memory_s=bytes_per_chip / HBM_BW,
        collective_s=(sum(n / LINK_TIERS[tier] for tier, n in
                          by_link.items()) if by_link is not None
                      else coll_bytes_per_chip / LINK_BW),
        flops_per_chip=flops_per_chip,
        bytes_per_chip=bytes_per_chip,
        coll_bytes_per_chip=coll_bytes_per_chip,
    )


def model_flops(cfg, shape, per_step: bool = True) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) for a train step;
    2*N*D for inference (forward only)."""
    n_params = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_params * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_params * tokens
    tokens = shape.global_batch  # decode: one token per sequence
    return 2.0 * n_params * tokens


# ---------------------------------------------------------------------------
# Anderson-round update pricing (fused vs staged)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TaaRoundCost:
    """Modeled per-iteration cost of one Theorem-3.2 Anderson update over a
    (T, D) window with history m: device-memory bytes moved and kernel
    launches, for the staged round (K1 ``taa_gram``, the solve, K2
    ``taa_apply``) against the fused one (K3 ``taa_round``)."""
    staged_bytes: int
    fused_bytes: int
    staged_launches: int = 3
    fused_launches: int = 1

    @property
    def byte_ratio(self) -> float:
        """staged / fused bytes — the fused round's traffic headroom."""
        return self.staged_bytes / self.fused_bytes

    @property
    def launch_ratio(self) -> float:
        return self.staged_launches / self.fused_launches


def taa_round_traffic(T: int, D: int, m: int, itemsize: int = 4) \
        -> TaaRoundCost:
    """Bytes each Anderson-round variant moves through device memory per
    iteration (the reference's model).

    Both variants pay the same two streaming sweeps over the (m, T, D)
    histories: the Gram pass reads dF and R, the apply pass reads dX, dF,
    x and R and writes the (T, D) output.  The staged round also writes
    its (T, m, m) + (T, m) Gram blocks out, reads them back for the solve,
    moves the (T, m) gammas out and in (the reference's host round trip),
    and the apply pass reads them again.  The fused round keeps all of
    that on chip in one launch.
    """
    big = T * D * itemsize                  # one (T, D) sheet
    hist = m * T * D * itemsize             # one (m, T, D) history
    blocks = T * (m * m + m) * itemsize     # per-row Gram blocks G + u
    gamma = T * m * itemsize                # the solved gammas
    fused = (hist + big) + (2 * hist + 3 * big)
    staged = fused + 2 * blocks + 4 * gamma
    return TaaRoundCost(staged_bytes=staged, fused_bytes=fused)
