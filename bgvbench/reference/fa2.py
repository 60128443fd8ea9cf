"""ForceAtlas2 (Jacomy et al. 2014; paper §3.1, Algorithm 1).

Per iteration, on positions ``p`` with masses ``m`` (kr = repulsion_k,
kg = gravity):

* gravity: ``−kg·m_i·p_i/|p_i|`` (|p_i| at least 1e-9);
* attraction: ``Σ_e w_e·(p_other − p_i)`` over the node's edges;
* repulsion, exact: ``Σ_j kr·m_i·m_j·(p_i − p_j)/(d'·d)`` with
  ``d = max(|p_i − p_j|, 1e-4)`` and, with radii ``r = √m``,
  ``d' = max(d − r_i − r_j, 1e-4)`` (else ``d' = d``);
* repulsion, grid: a G×G grid over the positions' bounding box, cell
  ``trunc((p − lo)/max(hi − lo, 1e-6)·G)`` clamped to [0, G); the far field
  is every other non-empty cell's mass at its centroid,
  ``kr·m_i·M_c·(p_i − c)/max(|p_i − c|², 1e-4)``; the near field sums the
  same pair force over the nodes of the node's own cell that lie within
  ``W`` places of it in the stable cell-sorted order;
* speed (Algorithm 1): swing ``|f − f_prev|``, traction ``|f + f_prev|/2``,
  global speed ``min(τ·Σm·traction / (Σm·swing + 1e-9), 1.5·s_prev +
  1e-3)`` from ``s = 1``; a node moves by ``min(s/(1 + s·√swing),
  10/max(|f|, 1e-9))·f``.

``dtype`` is the type positions, masses, weights and forces are kept in;
each force is computed in float32 and rounded once to it. The control
runs it in bfloat16.
"""
from __future__ import annotations

import torch

EPS = 1e-4


def gravity(p, m, kg: float):
    d = torch.linalg.vector_norm(p, dim=-1, keepdim=True)
    return -kg * m[:, None] * (p / torch.clamp(d, min=1e-9))


def attraction(p, src, dst, w, n: int):
    """src/dst [2E] (both directions), ids ≥ n are padding."""
    keep = (src < n) & (dst < n)
    s, d, ww = src[keep], dst[keep], w[keep]
    f = ww[:, None] * (p[d] - p[s])
    out = torch.zeros((n, 2), dtype=torch.float64, device=p.device)
    out.index_add_(0, s, f.double())
    return out.to(torch.float32)


def repulsion_exact(p, m, kr: float, radii=None, chunk: int = 2048):
    n = p.shape[0]
    out = torch.zeros((n, 2), dtype=torch.float32, device=p.device)
    idx = torch.arange(n, device=p.device)
    for i0 in range(0, n, chunk):
        pi, mi = p[i0:i0 + chunk], m[i0:i0 + chunk]
        dx = pi[:, 0:1] - p[None, :, 0]
        dy = pi[:, 1:2] - p[None, :, 1]
        d = torch.sqrt(torch.clamp(dx * dx + dy * dy, min=EPS * EPS))
        if radii is not None:
            eff = torch.clamp(d - radii[i0:i0 + chunk, None] - radii[None, :], min=EPS)
        else:
            eff = torch.clamp(d, min=EPS)
        mag = kr * mi[:, None] * m[None, :] / (eff * d)
        mag[idx[i0:i0 + chunk, None] == idx[None, :]] = 0.0
        out[i0:i0 + chunk, 0] = (mag * dx).sum(1)
        out[i0:i0 + chunk, 1] = (mag * dy).sum(1)
    return out


def grid_cells(p, g: int):
    lo = p.min(0).values
    hi = p.max(0).values
    ext = torch.clamp(hi - lo, min=1e-6)
    c2 = torch.clamp(((p - lo) / ext * g).to(torch.int32), 0, g - 1).long()
    return c2[:, 0] * g + c2[:, 1]


def repulsion_grid(p, m, kr: float, g: int, window: int, chunk: int = 16384):
    n = p.shape[0]
    cells = g * g
    cell = grid_cells(p, g)
    cm = torch.zeros(cells, dtype=torch.float64, device=p.device).index_add_(
        0, cell, m.double())
    cp = torch.zeros((cells, 2), dtype=torch.float64, device=p.device).index_add_(
        0, cell, p.double() * m.double()[:, None])
    cc = (cp / torch.clamp(cm, min=1e-9)[:, None]).float()
    cm = cm.float()
    out = torch.empty((n, 2), dtype=torch.float32, device=p.device)
    for i0 in range(0, n, chunk):
        pi, ci = p[i0:i0 + chunk], cell[i0:i0 + chunk]
        rows = torch.arange(pi.shape[0], device=p.device)
        dx = pi[:, 0:1] - cc[None, :, 0]
        dy = pi[:, 1:2] - cc[None, :, 1]
        d2 = dx * dx
        d2.addcmul_(dy, dy).clamp_(min=EPS)
        wgt = torch.div(cm[None, :], d2, out=d2)
        wgt[rows, ci] = 0.0  # the own cell's monopole is left out
        scale = kr * m[i0:i0 + chunk]
        out[i0:i0 + chunk, 0] = scale * torch.einsum("bc,bc->b", wgt, dx)
        out[i0:i0 + chunk, 1] = scale * torch.einsum("bc,bc->b", wgt, dy)
    order = torch.argsort(cell, stable=True)
    ps, ms, cs = p[order], m[order], cell[order]
    near = torch.zeros((n, 2), dtype=torch.float32, device=p.device)
    for k in range(1, window + 1):
        # pairs (i, i + k) of the sorted order in one cell, both directions
        dx = ps[:-k, 0] - ps[k:, 0]
        dy = ps[:-k, 1] - ps[k:, 1]
        mag = kr * ms[:-k] * ms[k:] / torch.clamp(dx * dx + dy * dy, min=EPS)
        mag = torch.where(cs[:-k] == cs[k:], mag, 0.0)
        f = torch.stack([mag * dx, mag * dy], 1)
        near[:-k] += f
        near[k:] -= f
    out[order] += near
    return out


class Layout:
    """The layout's fixed inputs and its loop."""

    def __init__(self, edges, weights, mass, n: int, *, iterations: int, kr: float,
                 kg: float, tau: float, repulsion: str, use_radii: bool,
                 grid_size: int = 64, grid_window: int = 32, dtype=torch.float32):
        # float32 products stay float32 (no TF32) in the einsums above
        torch.backends.cuda.matmul.allow_tf32 = False
        self.n, self.iterations = n, iterations
        self.kr, self.kg, self.tau = kr, kg, tau
        self.repulsion, self.g, self.window = repulsion, grid_size, grid_window
        self.dtype = dtype
        e = edges.long()
        self.src = torch.cat([e[:, 0], e[:, 1]])
        self.dst = torch.cat([e[:, 1], e[:, 0]])
        self.w = torch.cat([weights, weights]).to(dtype).float()
        self.m = mass.to(dtype).float()
        self.radii = torch.sqrt(torch.clamp(self.m, min=0.0)).to(dtype).float() \
            if use_radii else None

    def forces(self, p):
        f = gravity(p, self.m, self.kg)
        f = f + attraction(p, self.src, self.dst, self.w, self.n)
        if self.repulsion == "exact":
            f = f + repulsion_exact(p, self.m, self.kr, self.radii)
        else:
            f = f + repulsion_grid(p, self.m, self.kr, self.g, self.window)
        return f.to(self.dtype).float()

    def run(self, p0):
        """→ (positions [n, 2] float32, trace [iterations, 3] float64 of
        (Σm·swing + 1e-9, Σm·traction, global speed))."""
        p = p0.to(self.dtype).float()
        prev = torch.zeros_like(p)
        speed = torch.ones((), dtype=torch.float64, device=p.device)
        trace = torch.zeros((self.iterations, 3), dtype=torch.float64, device=p.device)
        m = self.m.double()
        for it in range(self.iterations):
            f = self.forces(p)
            swing = torch.linalg.vector_norm((f - prev).double(), dim=-1)
            tract = 0.5 * torch.linalg.vector_norm((f + prev).double(), dim=-1)
            gs = torch.sum(m * swing) + 1e-9
            gt = torch.sum(m * tract)
            speed = torch.minimum(self.tau * gt / gs, 1.5 * speed + 1e-3)
            local = speed / (1.0 + speed * torch.sqrt(swing))
            local = torch.minimum(local, 10.0 / torch.clamp(
                torch.linalg.vector_norm(f.double(), dim=-1), min=1e-9))
            p = (p.double() + local[:, None] * f.double()).to(self.dtype).float()
            prev = f
            trace[it] = torch.stack([gs, gt, speed])
        return p, trace
