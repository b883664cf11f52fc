"""Roofline terms of one device's step on an NVIDIA H100 SXM.

Port of ``repro.launch.hlo_analysis``'s ``Roofline`` and its ring pricing.
The reference parses XLA's partitioned HLO for its collectives; the port
has no HLO: ``launch.step_cost`` records each all-reduce at the gates of
``parallel.collective`` and prices it here with the reference's ring factor
(an all-reduce of R bytes over g devices moves ``2 * R * (g - 1) / g`` on
each device's link: a reduce-scatter then an all-gather).  Only the
all-reduce is priced: it is the one collective the port's step functions
make (the TP gates, the sharded MoE dispatch's gate, the data-parallel
gradient sum).

The terms are per device: the step's FLOPs over the card's peak, its bytes
over HBM bandwidth, its wire bytes over the link bandwidth.  The step time
at the roofline is the largest of the three (perfect overlap).  None of the
reference's TPU v5e figures carries over.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
PEAK_FLOPS = 989e12  # bf16 FLOP/s on the tensor cores (no sparsity)
HBM_BW = 3.35e12  # bytes/s of HBM3
# The wire: NVLink 4 gives 450 GB/s a direction between the 8 cards of one
# HGX node; across nodes each card has one NDR InfiniBand port, 400 Gb/s =
# 50 GB/s.  Every axis of the dry run's meshes is 16 or 32 devices wide
# (model 16; pod x data 16 or 32), so each ring crosses nodes and runs at
# the speed of its slowest link: the InfiniBand figure prices them all.
LINK_BW = 50e9  # bytes/s a card across nodes


def all_reduce_wire(nbytes: float, group: int) -> float:
    """Bytes one device sends for a ring all-reduce of ``nbytes`` over
    ``group`` devices (0 for a group of one)."""
    if group <= 1:
        return 0.0
    return 2.0 * nbytes * (group - 1) / group


@dataclasses.dataclass
class Roofline:
    flops: float  # per-device FLOPs of the step
    hbm_bytes: float  # per-device bytes accessed
    wire_bytes: float  # per-device collective wire bytes
    model_flops: Optional[float] = None  # 6ND / 2ND analytic, per-device share

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.wire_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> Optional[float]:
        if self.model_flops is None or self.flops == 0:
            return None
        return self.model_flops / self.flops

    @property
    def roofline_fraction(self) -> Optional[float]:
        """Useful (analytic model) FLOP/s at the roofline step time over the
        card's peak."""
        if self.model_flops is None or self.step_time_s == 0:
            return None
        return (self.model_flops / self.step_time_s) / PEAK_FLOPS

    def to_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "wire_bytes": self.wire_bytes,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }
