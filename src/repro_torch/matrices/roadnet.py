"""RoadNet matrix — an irregular graph Laplacian with imbalanced
communication volume (χ₃/χ₂ > 2), the regime the paper flags as where
uniform partitions break down (road networks, nonlinear programming).

The graph is a long *ring road* — a 1-D chain where node i touches
i ± 1..w — plus a dense *commuter corridor*: a pseudo-random k-regular
bipartite bundle of edges between the "city" region ``[0, m)`` and the
"suburb" region ``[c0, c0 + m)`` on the far side of the chain
(``c0 = n//2`` by default). Under the engine's uniform row partition the
two corridor endpoints concentrate essentially all remote traffic on the
two blocks that own them, while every other block only exchanges its
w-wide band boundary:

  * χ₂ (aggregate volume / D) stays small — only ~2m + O(P·w) remote
    entries exist in total,
  * χ₃ = N_p·max_p n_vc/D is ~N_p/2 × larger: one block owns a corridor
    endpoint, so the max is ~m while the mean is ~2m/N_p.

That makes RoadNet the worst case for the padded all_to_all engine
(every pair pays the corridor's max pair volume L ≈ m) and the best case
for the sparsity-compressed neighbor-permute engine (``core/spmv.py
comm="compressed"``): the corridor occupies a single cyclic shift, the
band occupies shifts ±1, and all other rounds are skipped — per-device
moved entries drop from ``P·L ≈ P·m`` to ``H ≈ m + 2w``.

The corridor is deterministic and involutive so any row chunk generates
its own pattern in O(k) per row: city node s links to suburb node
``(a·s + b_t) mod m`` for k fixed offsets b_t (a coprime to m), and
suburb node d links back to ``a⁻¹·(d - b_t) mod m`` — both directions
are closed-form, no global state. Values are the graph Laplacian
(diag = degree, off-diag = -1), symmetric real with spectrum in
[0, 2·max_degree].

The port's copy. The halo engines and schedules named above are the JAX
package's (``repro/core/spmv.py``); the port runs one shard, where these
operators have no DIA form (hundreds of diagonals) and take the ELL route.
"""
from __future__ import annotations

import numpy as np

from .families import MatrixFamily, register


@register
class RoadNet(MatrixFamily):
    name = "RoadNet"
    is_complex = False

    def __init__(self, n: int = 48000, w: int = 2, m: int = 1200,
                 k: int = 4, c0: int | None = None, seed: int = 1):
        self.n = int(n)
        self.w = int(w)
        self.m = int(m)
        self.k = int(k)
        self.c0 = int(c0) if c0 is not None else self.n // 2
        if not (self.m <= self.c0 and self.c0 + self.m <= self.n):
            raise ValueError("corridor regions [0, m) and [c0, c0+m) must "
                             "be disjoint and inside [0, n)")
        if not 1 <= self.k <= self.m:
            raise ValueError("need 1 <= k <= m corridor edges per node")
        rng = np.random.default_rng(seed)
        # multiplier coprime to m scatters each city node's k suburb links
        # across the whole endpoint region (ruling out accidental locality)
        a = int(rng.integers(1, self.m))
        while np.gcd(a, self.m) != 1:
            a = int(rng.integers(1, self.m))
        self.a = a
        self.a_inv = pow(a, -1, self.m)
        self.b = np.sort(rng.choice(self.m, size=self.k, replace=False))
        self.reach = self.c0 + self.m  # corridor span bounds |col - row|

    @property
    def D(self) -> int:
        return self.n

    # -------------------------------------------------------- pattern ----

    def _corridor(self, rows: np.ndarray):
        """Yield (row_sel, cols) corridor edges incident to ``rows``."""
        city = rows < self.m
        if city.any():
            s = rows[city]
            for t in range(self.k):
                yield rows[city], self.c0 + (self.a * s + self.b[t]) % self.m
        suburb = (rows >= self.c0) & (rows < self.c0 + self.m)
        if suburb.any():
            d = rows[suburb] - self.c0
            for t in range(self.k):
                yield rows[suburb], (self.a_inv * (d - self.b[t])) % self.m

    def row_cols(self, rows: np.ndarray):
        rows = np.asarray(rows, dtype=np.int64)
        out_r, out_c = [rows], [rows]  # Laplacian diagonal
        for d in range(1, self.w + 1):
            for sgn in (-1, 1):
                c = rows + sgn * d
                sel = (c >= 0) & (c < self.n)
                out_r.append(rows[sel])
                out_c.append(c[sel])
        for r, c in self._corridor(rows):
            out_r.append(r)
            out_c.append(c)
        return np.concatenate(out_r), np.concatenate(out_c)

    def row_entries(self, rows: np.ndarray):
        rows = np.asarray(rows, dtype=np.int64)
        # degree = band neighbors (clipped at the chain ends) + corridor
        deg = (np.minimum(rows + self.w, self.n - 1)
               - np.maximum(rows - self.w, 0)).astype(np.float64)
        in_corridor = (rows < self.m) | ((rows >= self.c0)
                                         & (rows < self.c0 + self.m))
        deg += self.k * in_corridor
        out_r, out_c, out_v = [rows], [rows], [deg]
        for d in range(1, self.w + 1):
            for sgn in (-1, 1):
                c = rows + sgn * d
                sel = (c >= 0) & (c < self.n)
                out_r.append(rows[sel])
                out_c.append(c[sel])
                out_v.append(np.full(int(sel.sum()), -1.0))
        for r, c in self._corridor(rows):
            out_r.append(r)
            out_c.append(c)
            out_v.append(np.full(len(r), -1.0))
        return (np.concatenate(out_r), np.concatenate(out_c),
                np.concatenate(out_v))

    def est_nnz(self, probe_rows: int = 4096) -> int:
        """Exact closed form: diagonal + end-clipped band + 2·m·k
        corridor entries (no duplicates by construction)."""
        return (self.n + 2 * self.w * self.n - self.w * (self.w + 1)
                + 2 * self.m * self.k)

    def spectral_bounds_hint(self):
        return (0.0, 2.0 * (2 * self.w + self.k))

    def describe(self) -> str:
        return (f"RoadNet,n={self.n},w={self.w},m={self.m},k={self.k} "
                f"(D={self.D})")
