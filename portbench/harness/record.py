"""What one run hands to the metric readers (``portbench/metrics/``)."""
from __future__ import annotations

import dataclasses
import hashlib


@dataclasses.dataclass
class Run:
    #: the cell's configuration and traffic files, as loaded
    config: dict
    traffic: dict
    #: seconds from the harness's start to the window's
    setup_s: float
    #: host seconds from the first solve's start to the last solve's end
    window_s: float
    #: one dict a solve: ``wall_s``, ``iterations``, ``total_spmvs``,
    #: ``degrees``, ``redist_s``, ``halo_bytes``, and in a traced run
    #: ``spans`` (seconds in ``init``, ``analyze`` and ``filter``)
    solves: list
    #: ``torch.cuda.max_memory_allocated()`` over the window
    peak_mem_bytes: int
    #: the reference's operator (SciPy CSR), for counting bytes
    A: object = None
    #: ``harness.trace.summarize`` of the traced window, else None
    trace: dict | None = None


def seed_of(seed: int, i) -> int:
    """A 63-bit generator seed for draw ``i`` of run ``seed``: any whole
    number, however large, and any label."""
    h = hashlib.sha256(f"{int(seed)}:{i}".encode()).digest()
    return int.from_bytes(h[:8], "little") & (2 ** 63 - 1)
