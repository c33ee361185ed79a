"""Roofline terms of a dry-run cell (the port of ``repro.analysis.roofline``).

Three terms per (arch × shape × mesh), on a device's datasheet constants:

    compute    = FLOPs_global      / (chips × peak FLOP/s)
    memory     = bytes_global      / (chips × HBM B/s)
    collective = collective_bytes  / (link B/s a chip)

The JAX package reads FLOPs and bytes from XLA's ``cost_analysis()`` and
the collective bytes from the partitioned HLO.  The port has neither: the
dry run (``repro_torch.launch.dryrun``) counts one rank's eager step on
fake tensors, and the collective bytes come from the port's own counters
(``serving.collective.Link``, tallied by kind under
``repro_torch.core.abstract``) under the same five kind keys.

:data:`H100` is the card the port runs on; :data:`V5E` carries the JAX
module's TPU v5e constants, so that the arithmetic can be held against the
JAX report's.  Every number these terms give is a prediction from a
datasheet, not a measurement.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

#: the collective kinds, as the JAX module parses them from HLO
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """A device's datasheet rates: dense bf16 FLOP/s, HBM bytes/s and the
    bytes/s a chip's collectives move at (``link_bw``), its memory."""

    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float
    memory_bytes: float


#: NVIDIA H100 80GB HBM3 (SXM5) at 700 W, NVIDIA's datasheet: 989 TFLOP/s
#: dense bf16, 3.35 TB/s HBM3, NVLink 450 GB/s a direction among the 8
#: GPUs of a node, and one 400 Gb/s NDR NIC (50 GB/s) a GPU across nodes.
#: Every axis of both production meshes spans more than 8 consecutive
#: ranks (``model`` 16 of them, ``data`` and ``pod`` strides of 16 and
#: 256), so each collective group crosses nodes and the collective term
#: runs at the NIC's 50 GB/s, not NVLink's.
H100 = DeviceSpec(name="NVIDIA H100 80GB HBM3 (SXM5), 700 W",
                  peak_flops=989e12, hbm_bw=3.35e12, link_bw=50e9,
                  memory_bytes=80e9)

#: the JAX module's TPU v5e constants (a chip's ICI link for collectives)
V5E = DeviceSpec(name="TPU v5e", peak_flops=197e12, hbm_bw=819e9,
                 link_bw=50e9, memory_bytes=16e9)


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_global: float
    bytes_global: float
    collective_bytes_per_chip: float
    collectives_detail: Dict[str, float]
    model_flops: float
    peak_memory_bytes_per_chip: Optional[float] = None
    device: DeviceSpec = H100

    @property
    def t_compute(self) -> float:
        return self.flops_global / (self.chips * self.device.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.bytes_global / (self.chips * self.device.hbm_bw)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_chip / self.device.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs: remat and redundancy show here."""
        return self.model_flops / max(self.flops_global, 1.0)

    @property
    def roofline_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """compute-term / bound: 1.0 == perfectly compute-bound (ideal)."""
        return self.t_compute / max(self.roofline_time, 1e-30)

    @property
    def fits(self) -> Optional[bool]:
        """Whether the peak a chip fits the device's memory (None where no
        peak was counted)."""
        if self.peak_memory_bytes_per_chip is None:
            return None
        return self.peak_memory_bytes_per_chip <= self.device.memory_bytes

    def to_dict(self) -> Dict:
        """The JAX report's keys."""
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "flops_global": self.flops_global,
            "bytes_global": self.bytes_global,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "collectives_detail": self.collectives_detail,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "peak_memory_bytes_per_chip": self.peak_memory_bytes_per_chip,
        }


def model_flops_estimate(cfg, shape) -> float:
    """6·N·D (dense) or 6·N_active·D for training; 2·N·D per generated/
    prefilled token for inference (decode: one token per sequence)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one new token per sequence (+ attention over the cache, which
    # 2·N·D does not count: this is the "useful" floor)
    return 2.0 * n * shape.global_batch


def build_report(arch: str, shape_cfg, mesh_desc: str, chips: int,
                 cost: Dict, cfg, memory_stats: Optional[Dict] = None,
                 colls: Optional[Dict[str, float]] = None,
                 device: DeviceSpec = H100) -> RooflineReport:
    """The report of a cell from a rank's counted ``cost`` (``flops`` and
    ``bytes accessed`` a chip) and collective bytes by kind (``colls``, a
    chip; every kind of :data:`COLLECTIVES` present, 0 where none ran)."""
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    colls = {k: float((colls or {}).get(k, 0.0)) for k in COLLECTIVES}
    return RooflineReport(
        arch=arch, shape=shape_cfg.name, mesh=mesh_desc, chips=chips,
        flops_global=flops_dev * chips,
        bytes_global=bytes_dev * chips,
        collective_bytes_per_chip=float(sum(colls.values())),
        collectives_detail=colls,
        model_flops=model_flops_estimate(cfg, shape_cfg),
        peak_memory_bytes_per_chip=(memory_stats or {}).get("peak_bytes"),
        device=device)
