"""HubNet matrix — a hub-and-spoke "airline" graph Laplacian that is the
worst case for the *cyclic* neighbor schedule and the showcase for the
*matching* schedule (``core/spmv.py schedule="matching"``).

The graph is a 1-D chain with a w-wide band (node i touches i ± 1..w —
the light "regional" traffic) plus ``h`` *hub airports*: disjoint node
regions of ``m`` nodes each, placed at pseudo-random positions along the
chain and linked into a single pseudo-random cycle of dense *corridors*
(hub i's region ↔ the next hub's region, k involutive bipartite edges
per node — the same closed-form construction as RoadNet's commuter
corridor, one corridor per consecutive hub pair).

Under the engine's uniform row partition each corridor concentrates
~m distinct remote columns on the one block that owns its endpoint
region, while every other pair of blocks only exchanges its band
boundary:

  * few hot receivers — only the h hub blocks carry corridor traffic,
    so χ₃ = N_p·max_p n_vc/D exceeds χ₂ = Σ_p n_vc/D by ≈ N_p/h
    (χ₃/χ₂ ≫ 1 for h ≪ N_p),
  * the corridors land on *many distinct cyclic shifts* (pseudo-random
    hub placement), so the cyclic schedule pays one full ~m-sized round
    per corridor shift: ``H_cyclic ≈ min(2h, N_p-1)·m`` saturates toward
    the padded a2a's ``N_p·m`` — per-round padding buys almost nothing
    here,
  * the hub blocks are (mostly) pairwise distinct and the corridor
    cycle visits each region once as source and once as destination, so
    a matching packs *all* forward corridors into one permutation round
    and all backward corridors into another: ``H_matching ≈ 2m + 2w``,
    beating cyclic by ≈ h.

That makes HubNet the family where ``--layout auto`` demonstrably picks
``schedule="matching"``: the greedy matching decomposition recovers the
factor h that both the padded all_to_all (χ₃) and the cyclic rounds
(one round per shift) leave on the wire.

The corridors are deterministic and involutive so any row chunk
generates its own pattern in O(k) per row: source node ``c_i + s`` links
to ``c_j + (a·s + b_t) mod m`` for k fixed offsets b_t (a coprime to m),
and destination node ``c_j + d`` links back to
``c_i + a⁻¹·(d - b_t) mod m``. Values are the graph Laplacian
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
class HubNet(MatrixFamily):
    name = "HubNet"
    is_complex = False

    def __init__(self, n: int = 48000, w: int = 2, h: int = 5,
                 m: int = 512, k: int = 4, seed: int = 1):
        self.n = int(n)
        self.w = int(w)
        self.h = int(h)
        self.m = int(m)
        self.k = int(k)
        if self.h < 3:
            raise ValueError("need h >= 3 hubs (a 2-cycle would duplicate "
                             "corridor edges)")
        if self.m < 2:
            raise ValueError("need m >= 2 nodes per hub region (the "
                             "corridor multiplier needs a nontrivial "
                             "residue ring)")
        if not 1 <= self.k <= self.m:
            raise ValueError("need 1 <= k <= m corridor edges per node")
        rng = np.random.default_rng(seed)
        # pseudo-random hub placement with gaps wide enough that regions
        # are disjoint and band edges never reach a foreign region
        gap = self.m + self.w
        if self.h * (self.m + gap) >= self.n:
            raise ValueError(f"n={self.n} too small for {self.h} disjoint "
                             f"hub regions of m={self.m}")
        for _ in range(1000):
            pos = np.sort(rng.integers(0, self.n - self.m, size=self.h))
            if (np.diff(pos) > gap).all():
                break
        else:  # pragma: no cover - the size guard above makes this rare
            raise ValueError("could not place disjoint hub regions")
        self.pos = pos
        # one pseudo-random cycle over the hubs: region order[j] sends a
        # corridor to region order[j+1] — every region is the source of
        # exactly one corridor and the destination of exactly one
        order = rng.permutation(self.h)
        self.corridors = tuple(
            (int(order[j]), int(order[(j + 1) % self.h]))
            for j in range(self.h))
        # multiplier coprime to m scatters each source node's k links
        # across the whole destination region (no accidental locality)
        a = int(rng.integers(1, self.m))
        while np.gcd(a, self.m) != 1:
            a = int(rng.integers(1, self.m))
        self.a = a
        self.a_inv = pow(a, -1, self.m)
        self.b = np.sort(rng.choice(self.m, size=self.k, replace=False))
        # corridor span bounds |col - row| (windows the exact χ scan)
        self.reach = int(max(abs(int(self.pos[j]) - int(self.pos[i]))
                             for i, j in self.corridors) + self.m)

    @property
    def D(self) -> int:
        return self.n

    # -------------------------------------------------------- pattern ----

    def _corridor(self, rows: np.ndarray):
        """Yield (row_sel, cols) corridor edges incident to ``rows`` —
        both directions of every corridor, via the involutive map."""
        for i, j in self.corridors:
            ci, cj = int(self.pos[i]), int(self.pos[j])
            src = (rows >= ci) & (rows < ci + self.m)
            if src.any():
                s = rows[src] - ci
                for t in range(self.k):
                    yield rows[src], cj + (self.a * s + self.b[t]) % self.m
            dst = (rows >= cj) & (rows < cj + self.m)
            if dst.any():
                d = rows[dst] - cj
                for t in range(self.k):
                    yield rows[dst], ci + (self.a_inv * (d - self.b[t])) % self.m

    def _in_region(self, rows: np.ndarray) -> np.ndarray:
        hit = np.zeros(len(rows), dtype=bool)
        for c in self.pos:
            hit |= (rows >= c) & (rows < c + self.m)
        return hit

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
        # degree = band neighbors (clipped at the chain ends) + corridors
        deg = (np.minimum(rows + self.w, self.n - 1)
               - np.maximum(rows - self.w, 0)).astype(np.float64)
        deg += 2 * self.k * self._in_region(rows)
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
        """Exact closed form: diagonal + end-clipped band + h corridors
        of 2·m·k entries each (every region is one corridor's source and
        another's destination)."""
        return (self.n + 2 * self.w * self.n - self.w * (self.w + 1)
                + 2 * self.h * self.m * self.k)

    def spectral_bounds_hint(self):
        return (0.0, 2.0 * (2 * self.w + 2 * self.k))

    def describe(self) -> str:
        return (f"HubNet,n={self.n},w={self.w},h={self.h},m={self.m},"
                f"k={self.k} (D={self.D})")
