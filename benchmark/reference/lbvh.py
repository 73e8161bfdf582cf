"""The reference's own acceleration structure: a linear BVH.

Built from the triangles the benchmark made, and from nothing of the
program: the triangles are sorted by the 30-bit Morton code of their
centroids, cut into leaves of ``LEAF`` consecutive triangles, and a
complete binary tree in heap order (node 1 the root, node i's children
2i and 2i + 1, the leaves from ``n_leaves`` on) bounds them.  Boxes are
widened by a margin so that the float32 slab test never loses a
triangle the exact one would reach; a box only culls, and every
triangle a ray may hit is tested with Moller-Trumbore under the
reference's rules:

  a == 0 rejected, u in [0, 1], v >= 0, u + v <= 1, t > 0 strictly,

the nearest t winning and, on an exact tie, the least triangle index of
the benchmark's own array.  Traversal runs every live ray at once, each
with its own stack, until every stack is empty.
"""
from __future__ import annotations

import math

import torch

LEAF = 8
STACK = 48
_BIG = 2 ** 62


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _morton(q: torch.Tensor) -> torch.Tensor:
    """Interleave three 10-bit int64 coordinates into a 30-bit code."""
    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249
    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


class LBVH:
    """The tree over (T, 3) float32 vertex arrays ``v0``, ``v1``, ``v2``
    (world space, on one device).  ``order[j]`` is the triangle index of
    sorted slot j (-1 for a padding slot)."""

    def __init__(self, v0: torch.Tensor, v1: torch.Tensor, v2: torch.Tensor):
        dev = v0.device
        t = v0.shape[0]
        cen = (v0 + v1 + v2) / 3.0
        lo, hi = cen.min(0).values, cen.max(0).values
        q = ((cen - lo) / torch.clamp(hi - lo, min=1e-30) * 1023.0)
        code = _morton(q.clamp(0, 1023).long())
        order = torch.argsort(code, stable=True)
        leaves = max(1, -(-t // LEAF))
        self.n_leaves = 1 << max(0, math.ceil(math.log2(leaves)))
        slots = self.n_leaves * LEAF
        self.order = torch.full((slots,), -1, dtype=torch.int64, device=dev)
        self.order[:t] = order
        real = self.order >= 0
        idx = self.order.clamp_min(0)
        self.v0 = torch.where(real[:, None], v0[idx], 0.0)
        self.e1 = torch.where(real[:, None], v1[idx] - v0[idx], 0.0)
        self.e2 = torch.where(real[:, None], v2[idx] - v0[idx], 0.0)
        # the leaves' boxes, then each level's from its children's
        pts = torch.stack([v0[idx], v1[idx], v2[idx]], 1)     # (slots, 3, 3)
        inf = torch.tensor(math.inf, device=dev)
        lo_t = torch.where(real[:, None], pts.min(1).values, inf)
        hi_t = torch.where(real[:, None], pts.max(1).values, -inf)
        lo_l = lo_t.reshape(self.n_leaves, LEAF, 3).min(1).values
        hi_l = hi_t.reshape(self.n_leaves, LEAF, 3).max(1).values
        lo_n = torch.full((2 * self.n_leaves, 3), math.inf, device=dev)
        hi_n = torch.full((2 * self.n_leaves, 3), -math.inf, device=dev)
        lo_n[self.n_leaves:], hi_n[self.n_leaves:] = lo_l, hi_l
        width = self.n_leaves // 2
        while width >= 1:
            kids = torch.arange(2 * width, 4 * width, device=dev)
            lo_n[width:2 * width] = torch.minimum(lo_n[kids[0::2]],
                                                  lo_n[kids[1::2]])
            hi_n[width:2 * width] = torch.maximum(hi_n[kids[0::2]],
                                                  hi_n[kids[1::2]])
            width //= 2
        # the margin: far above the rounding of a float32 slab test
        extent = float(torch.nan_to_num(hi_n[1] - lo_n[1]).abs().max()) + 1.0
        margin = 1e-4 * extent
        self.lo = lo_n - margin
        self.hi = hi_n + margin
        # a box over padding slots alone bounds nothing: its inverted
        # corners would admit every ray
        self.empty = (lo_n > hi_n).any(1)

    def _slab(self, nodes, o, inv, t_max):
        """(admitted, entry t) of rays (o, 1/d) against ``nodes``' boxes,
        entry before ``t_max``; NaN products (0 * inf) count as inside."""
        t1 = (self.lo[nodes] - o) * inv
        t2 = (self.hi[nodes] - o) * inv
        near = torch.nan_to_num(torch.minimum(t1, t2), nan=-math.inf,
                                posinf=math.inf, neginf=-math.inf)
        far = torch.nan_to_num(torch.maximum(t1, t2), nan=math.inf,
                               posinf=math.inf, neginf=-math.inf)
        t_in = near.max(-1).values
        t_out = far.min(-1).values
        return ((t_out >= torch.clamp_min(t_in, 0.0)) & (t_in <= t_max)
                & ~self.empty[nodes]), t_in

    def nearest(self, o: torch.Tensor, d: torch.Tensor, t_limit: torch.Tensor,
                dtype=torch.float32):
        """Nearest triangle hit strictly before ``t_limit`` of the (R, 3)
        rays: (t (inf for none), triangle index (-1 for none)).  The
        Moller-Trumbore arithmetic runs in ``dtype``; the boxes in
        float32."""
        r = o.shape[0]
        dev = o.device
        of, df = o.float(), d.float()
        inv = 1.0 / df
        best_t = t_limit.to(dtype).clone()
        best_i = torch.full((r,), -1, dtype=torch.int64, device=dev)
        stack_n = torch.zeros((r, STACK), dtype=torch.int32, device=dev)
        stack_t = torch.zeros((r, STACK), dtype=torch.float32, device=dev)
        sp = torch.zeros(r, dtype=torch.int64, device=dev)
        root = torch.ones(r, dtype=torch.int64, device=dev)
        ok, t_in = self._slab(root, of, inv, best_t.float())
        # a NaN ray (the RNG's ln(0) hazard) meets nothing: its slab test
        # would admit every box
        ok &= torch.isfinite(of).all(-1) & torch.isfinite(df).all(-1)
        stack_n[:, 0] = 1
        stack_t[:, 0] = t_in
        sp[ok] = 1
        act = torch.nonzero(ok)[:, 0]
        v0, e1, e2 = (x.to(dtype) for x in (self.v0, self.e1, self.e2))
        lane = torch.arange(LEAF, device=dev)
        while act.numel():
            top = sp[act] - 1
            node = stack_n[act, top].long()
            t_node = stack_t[act, top]
            sp[act] = top
            # a node whose box begins beyond the nearest hit is dropped
            live = t_node <= best_t[act].float()
            cur, node = act[live], node[live]
            leaf = node >= self.n_leaves
            # internal nodes: test both children, push the far one first
            ai, ni = cur[~leaf], node[~leaf]
            if ai.numel():
                tm = best_t[ai].float()
                kid_l, kid_r = 2 * ni, 2 * ni + 1
                hl, tl = self._slab(kid_l, of[ai], inv[ai], tm)
                hr, tr = self._slab(kid_r, of[ai], inv[ai], tm)
                left_near = tl <= tr
                far_n = torch.where(left_near, kid_r, kid_l)
                far_t = torch.where(left_near, tr, tl)
                far_h = torch.where(left_near, hr, hl)
                near_n = torch.where(left_near, kid_l, kid_r)
                near_t = torch.where(left_near, tl, tr)
                near_h = torch.where(left_near, hl, hr)
                for h, n, tt in ((far_h, far_n, far_t),
                                 (near_h, near_n, near_t)):
                    rows = ai[h]
                    pos = sp[rows]
                    stack_n[rows, pos] = n[h].int()
                    stack_t[rows, pos] = tt[h]
                    sp[rows] = pos + 1
            # leaves: every slot of the leaf against its rays
            al, nl = cur[leaf], node[leaf]
            if al.numel():
                slot = (nl - self.n_leaves)[:, None] * LEAF + lane   # (n, L)
                t = _moller_trumbore(o[al].to(dtype)[:, None],
                                     d[al].to(dtype)[:, None],
                                     v0[slot], e1[slot], e2[slot])
                t = torch.where(self.order[slot] >= 0, t, math.inf)
                tmin = t.min(1).values
                cand = torch.where(t == tmin[:, None], self.order[slot], _BIG)
                imin = cand.min(1).values
                bt, bi = best_t[al], best_i[al]
                better = (tmin < bt) | ((tmin == bt) & (bi >= 0)
                                        & (imin < bi))
                best_t[al] = torch.where(better, tmin, bt)
                best_i[al] = torch.where(better, imin, bi)
            act = act[sp[act] > 0]
        best_t = torch.where(best_i >= 0, best_t, math.inf)
        return best_t, best_i


def _moller_trumbore(o, d, v0, e1, e2):
    """t of rays (n, 1, 3) against triangles (n, L, 3), inf where the
    reference's rules reject the pair."""
    h = _cross(d, e2)
    a = _dot(e1, h)
    f = 1.0 / a
    s = o - v0
    u = f * _dot(s, h)
    q = _cross(s, e1)
    v = f * _dot(d, q)
    t = f * _dot(e2, q)
    valid = ((a != 0) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
             & (t > 0))
    return torch.where(valid, t, math.inf)
