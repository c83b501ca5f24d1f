"""Roofline terms of a counted step on one H100.

The port's counterpart of ``repro/launch/roofline.py``: the same three
terms, fields and row, in seconds a step, with the H100's constants in
place of the reference's TPU ones:

  compute    = flops_per_chip / peak of the step's dtype
  memory     = hbm_bytes_per_chip / 3.35 TB/s (HBM3, H100 SXM data sheet)
  collective = coll_bytes_per_chip / b_c of ``h100-1card``

The peaks are NVIDIA's H100 SXM data sheet's dense rates: 989 TFLOP/s in
bf16 and fp16 on the tensor cores, and outside them the 67 TFLOP/s fp32
and 33.5 TFLOP/s fp64 that ``chip_smoke.py`` bounds its kernels by (a
complex dtype at its planes' rate). The shards of one card exchange by
device copies, so the collective term is priced at the rate of those
copies, the fitted ``b_c`` of ``core/perf_model.py::H100_1CARD``.

The counts come from ``launch/op_analysis.py`` (an ``OpCosts``), not from
a compiled artifact, and there is no HLO text to parse: the reference's
``collective_bytes(hlo_text)`` has no counterpart (the shard groups count
their collectives themselves).
"""
from __future__ import annotations

import dataclasses

from ..core.perf_model import H100_1CARD

__all__ = ["HBM_BW", "PEAK_FLOPS", "COLL_BW", "Roofline", "analyze",
           "memory_summary"]

HBM_BW = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "float64": 33.5e12, "complex64": 67e12, "complex128": 33.5e12}
COLL_BW = H100_1CARD.b_c


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    hbm_bytes_per_chip: float
    #: None where nothing counts the collectives (a step on the meta
    #: device has no shard groups); its term is then None too
    coll_bytes_per_chip: float | None
    coll_breakdown: dict | None
    model_flops_total: float
    n_chips: int
    dtype: str = "bfloat16"

    @property
    def peak_flops(self) -> float:
        return PEAK_FLOPS[self.dtype]

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float | None:
        if self.coll_bytes_per_chip is None:
            return None
        return self.coll_bytes_per_chip / COLL_BW

    def _terms(self) -> dict:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def dominant(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (counted flops · chips): recompute and redundancy."""
        tot = self.flops_per_chip * self.n_chips
        return self.model_flops_total / tot if tot else 0.0

    def _useful_time(self) -> float:
        return self.model_flops_total / self.n_chips / self.peak_flops

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / additive step time."""
        t_total = sum(self._terms().values())
        return self._useful_time() / t_total if t_total else 0.0

    @property
    def roofline_fraction_overlap(self) -> float:
        """The same, with the terms perfectly overlapped (their max)."""
        t_total = max(self._terms().values())
        return self._useful_time() / t_total if t_total else 0.0

    def row(self) -> dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "roofline_fraction_overlap": self.roofline_fraction_overlap,
            "coll_breakdown": self.coll_breakdown,
            "flops_per_chip": self.flops_per_chip,
            "hbm_bytes_per_chip": self.hbm_bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "roofline_dtype": self.dtype,
        }


def analyze(costs, model_flops_total: float, n_chips: int, *,
            dtype: str = "bfloat16", collectives: bool = True) -> Roofline:
    """Roofline terms from an ``OpCosts`` of the whole step, split evenly
    over ``n_chips``; ``collectives=False`` where no shard group counted
    them (the collective term is then None)."""
    return Roofline(
        flops_per_chip=costs.flops / n_chips,
        hbm_bytes_per_chip=costs.hbm_bytes / n_chips,
        coll_bytes_per_chip=costs.coll_bytes / n_chips if collectives
        else None,
        coll_breakdown={k: int(v) for k, v in costs.coll_breakdown.items()}
        if collectives else None,
        model_flops_total=model_flops_total, n_chips=n_chips, dtype=dtype)


def memory_summary(argument_bytes: int, output_bytes: int,
                   device=None) -> dict:
    """Bytes a chip holds for the step's arguments and outputs (from the
    per-chip shapes) and, on the card, the peak the step allocated there
    (``torch.cuda.max_memory_allocated``, measured: not a compiler's
    estimate)."""
    out = {"argument_size_in_bytes": int(argument_bytes),
           "output_size_in_bytes": int(output_bytes)}
    if device is not None and getattr(device, "type", device) == "cuda":
        import torch

        out["cuda_max_memory_allocated_bytes"] = int(
            torch.cuda.max_memory_allocated(device))
    return out
