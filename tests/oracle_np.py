"""Pure-Python restatement of the reference simulation semantics.

An independent, particle-level implementation of the serial algorithm
(reference serial/parsim.cpp) used as a unit-test oracle: Python floats are
IEEE doubles and Python arithmetic never contracts into FMA, so this produces
the same bits as the reference binary for the same operation order. Buckets
are rebuilt cleanly after movement (the reference's incremental repair is
buggy; SURVEY §2.2 C9 verified the clean rebuild reproduces every golden
vector).

Deliberately simple and slow — for N up to a few hundred in tests.
"""

from __future__ import annotations

import math

G = 6.67408e-11
EPSILON = 0.005
DELTAT = 0.1


class NpOracle:
    def __init__(self, side, ncside, x, y, vx, vy, m):
        self.side = float(side)
        self.nc = int(ncside)
        self.x = [float(v) for v in x]
        self.y = [float(v) for v in y]
        self.vx = [float(v) for v in vx]
        self.vy = [float(v) for v in vy]
        self.m = [float(v) for v in m]
        self.alive = [True] * len(self.x)
        self.collisions = 0

    def _cell(self, i):
        w = self.side / self.nc
        cx = int(self.x[i] / w)
        cy = int(self.y[i] / w)
        if cx < 0 or cx >= self.nc or cy < 0 or cy >= self.nc:
            return None  # reference [PANIC2] skip
        return cy * self.nc + cx

    def _buckets(self):
        buckets = [[] for _ in range(self.nc * self.nc)]
        for i in range(len(self.x)):
            c = self._cell(i)
            if c is not None:
                buckets[c].append(i)
        return buckets

    def step(self):
        n = len(self.x)
        nc, side = self.nc, self.side
        buckets = self._buckets()

        # COM: incremental running weighted mean, in bucket order.
        cm = [0.0] * (nc * nc)
        cmx = [0.0] * (nc * nc)
        cmy = [0.0] * (nc * nc)
        for c, bucket in enumerate(buckets):
            for i in bucket:
                if cm[c] == 0.0:
                    cmx[c] = self.x[i]
                    cmy[c] = self.y[i]
                else:
                    cmx[c] = (cmx[c] * cm[c] + self.m[i] * self.x[i]) / (cm[c] + self.m[i])
                    cmy[c] = (cmy[c] * cm[c] + self.m[i] * self.y[i]) / (cm[c] + self.m[i])
                cm[c] += self.m[i]

        # Forces.
        fx = [0.0] * n
        fy = [0.0] * n
        for c, bucket in enumerate(buckets):
            cx, cy = c % nc, c // nc
            temp = []
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    if dx == 0 and dy == 0:
                        continue
                    tx = 0.0
                    ty = 0.0
                    if cx + dx >= nc:
                        tx += side
                    elif cx + dx < 0:
                        tx -= side
                    if cy + dy >= nc:
                        ty += side
                    elif cy + dy < 0:
                        ty -= side
                    nb = ((cx + dx) % nc) + ((cy + dy) % nc) * nc
                    temp.append((tx + cmx[nb], ty + cmy[nb], cm[nb]))
            for jj, i in enumerate(bucket):
                for k in bucket[jj + 1:]:
                    if self.alive[i] and self.alive[k]:
                        dx_ = self.x[k] - self.x[i]
                        dy_ = self.y[k] - self.y[i]
                        d2 = dx_ * dx_ + dy_ * dy_
                        dist = math.sqrt(d2)
                        if dist == 0:
                            continue
                        fm = (G * self.m[i]) * self.m[k] / d2
                        fxa = fm * (dx_ / dist)
                        fya = fm * (dy_ / dist)
                        fx[i] += fxa
                        fy[i] += fya
                        fx[k] -= fxa
                        fy[k] -= fya
                if self.alive[i]:
                    for (tmx, tmy, tm) in temp:
                        dx_ = tmx - self.x[i]
                        dy_ = tmy - self.y[i]
                        d2 = dx_ * dx_ + dy_ * dy_
                        dist = math.sqrt(d2)
                        if dist == 0:
                            continue
                        fm = (G * self.m[i]) * tm / d2
                        fx[i] += fm * (dx_ / dist)
                        fy[i] += fm * (dy_ / dist)

        # Integrate + wrap; dead particles frozen.
        for i in range(n):
            if self.m[i] == 0:
                continue
            ax = fx[i] / self.m[i]
            ay = fy[i] / self.m[i]
            self.x[i] += self.vx[i] * DELTAT + ((0.5 * ax) * DELTAT) * DELTAT
            self.y[i] += self.vy[i] * DELTAT + ((0.5 * ay) * DELTAT) * DELTAT
            self.vx[i] += ax * DELTAT
            self.vy[i] += ay * DELTAT
            self.x[i] = math.fmod(self.x[i] + side, side)
            self.y[i] = math.fmod(self.y[i] + side, side)

        # Collisions on post-move buckets, set-counting rule.
        buckets = self._buckets()
        for bucket in buckets:
            in_set = set()
            for jj, i in enumerate(bucket):
                if not self.alive[i]:
                    continue
                for k in bucket[jj + 1:]:
                    if not self.alive[k]:
                        continue
                    dx_ = self.x[i] - self.x[k]
                    dy_ = self.y[i] - self.y[k]
                    if math.sqrt(dx_ * dx_ + dy_ * dy_) < EPSILON:
                        if i not in in_set and k not in in_set:
                            self.collisions += 1
                        in_set.add(i)
                        in_set.add(k)
            for i in in_set:
                self.alive[i] = False
                self.m[i] = 0.0


def tile_pair_forces(x, y, m):
    """Direct-sum pairwise forces over (ncells, K) slot tiles, in f64.

    The plain reference for the fast engines' tile pair passes
    (ops/dense_xla.fused_pairs_v*, collide=False): every pair of occupied
    slots in one tile row interacts (reference serial/parsim.cpp:292-377),
    empty slots carry m=0. Vectorized NumPy; returns (fx, fy) f64 tiles.
    """
    import numpy as np

    x, y, m = (np.asarray(a, np.float64) for a in (x, y, m))
    fx = np.zeros_like(x)
    fy = np.zeros_like(x)
    for c0 in range(0, x.shape[0], 256):      # bound the (cb, K, K) temps
        sl = slice(c0, c0 + 256)
        dx = x[sl, None, :] - x[sl, :, None]
        dy = y[sl, None, :] - y[sl, :, None]
        d2 = dx * dx + dy * dy
        nz = d2 > 0
        inv3 = np.where(nz, 1.0 / np.where(nz, d2, 1.0) ** 1.5, 0.0)
        s = G * m[sl, :, None] * m[sl, None, :] * inv3
        fx[sl] = (s * dx).sum(axis=2)
        fy[sl] = (s * dy).sum(axis=2)
    return fx, fy
