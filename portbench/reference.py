"""Plain reference of the benchmark: the randomized approximate Cholesky
factor of a graph from its key, the preconditioner apply, the Laplacian
and PCG, in plain PyTorch.  It imports nothing of the program and reads
nothing the program made: it takes the benchmark's own edge arrays and
keys.

The factor is the sequential oracle's (paper Algorithms 1 + 2: vertices
eliminated in label order, each column's sampled spanning-tree edges
appended to the bucket of their smaller endpoint), with the per-column
math and the counter-based randomness copied and frozen here:

* slot ``i`` of vertex ``v`` draws ``uniform(fold_in(fold_in(key, v), i))``
  of threefry-2x32 (JAX's default generator, partitionable mode), so a
  column's draws do not depend on when it is eliminated;
* a column's result depends on the multiset of edges in its bucket alone
  (sorted before any sum), and scans are bracketed by position only, so
  it does not depend on the padded width either.

So :func:`factor` eliminates every vertex whose bucket is final (no live
edge still ends in it) at once, round after round, and gives the oracle's
bits; :func:`factor_sequential`, the oracle itself, holds it to that in
the tests at small sizes.  ``dtype`` is the precision of the elimination
(float32, as the configurations state; bfloat16 for the control).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

INVALID_ID = 2 ** 31 - 1
_M32 = 0xFFFFFFFF


class Factor(NamedTuple):
    """``L ≈ G D Gᵀ``: unit lower-triangular ``G`` in label order as CSC
    (column ``k``'s rows, ascending, are ``> k``) and the diagonal ``D``."""

    col_ptr: np.ndarray   # int64[n+1]
    rows: np.ndarray      # int32[nnz]
    vals: np.ndarray      # float[nnz]
    D: np.ndarray         # float[n]


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


# ---------------------------------------------------------------------------
# threefry-2x32 on int64 tensors holding uint32 values
# ---------------------------------------------------------------------------

def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in rot[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def _fold_in(k1, k2, data):
    return threefry2x32(k1, k2, torch.zeros_like(data), data & _M32)


def _uniform(k1, k2):
    zero = torch.zeros_like(k1)
    y1, y2 = threefry2x32(k1, k2, zero, zero)
    bits = ((y1 ^ y2) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def column_uniforms(key, vertices: torch.Tensor, width: int) -> torch.Tensor:
    """``u[r, i] = uniform(fold_in(fold_in(key, vertices[r]), i))``."""
    k = np.asarray(key, np.uint64).reshape(2)
    v = vertices.to(torch.int64)[:, None]
    kv1, kv2 = _fold_in(torch.full_like(v, int(k[0])),
                        torch.full_like(v, int(k[1])), v)
    slots = torch.arange(width, dtype=torch.int64,
                         device=v.device)[None, :].expand(v.shape[0], -1)
    ki1, ki2 = _fold_in(kv1.expand(-1, width), kv2.expand(-1, width), slots)
    return _uniform(ki1, ki2)


# ---------------------------------------------------------------------------
# one column's elimination, rows batched
# ---------------------------------------------------------------------------

def _hs_cumsum(x):
    """Inclusive prefix sum bracketed by position alone (Hillis–Steele
    over the next power of two)."""
    w = x.shape[-1]
    n2 = _next_pow2(w)
    x = torch.nn.functional.pad(x, (0, n2 - w))
    k = 1
    while k < n2:
        x = x + torch.nn.functional.pad(x[..., :-k], (k, 0))
        k *= 2
    return x[..., :w]


def _hs_suffix_sum(x):
    return torch.flip(_hs_cumsum(torch.flip(x, (-1,))), (-1,))


def _lexsort2(k1, k2):
    """Row-wise order ascending by ``(k1, k2)``, ties in lane order."""
    o = torch.argsort(k2, dim=-1, stable=True)
    o2 = torch.argsort(torch.gather(k1, -1, o), dim=-1, stable=True)
    return torch.gather(o, -1, o2)


def _searchsorted_right(a, v):
    """``searchsorted(a, v, side="right")`` by ``ceil(log2(W+1))``
    halvings with the probe ``v < a[mid]`` (answers as the oracle does
    where a row is out of order by an ulp)."""
    W = a.shape[-1]
    low = torch.zeros_like(v, dtype=torch.int64)
    high = torch.full_like(low, W)
    for _ in range(int(math.ceil(math.log2(W + 1)))):
        mid = (low + high) // 2
        go_left = v < torch.gather(a, -1, mid)
        low, high = (torch.where(go_left, low, mid),
                     torch.where(go_left, mid, high))
    return high


class _Elim(NamedTuple):
    g_rows: torch.Tensor
    g_vals: torch.Tensor
    m: torch.Tensor
    ell_kk: torch.Tensor
    e_lo: torch.Tensor
    e_hi: torch.Tensor
    e_w: torch.Tensor
    e_valid: torch.Tensor


def eliminate(ids, ws, valid, u) -> _Elim:
    """Eliminate R vertices, each given its padded bucket ``[R, W]``:
    merge parallel edges, ``ℓ_kk`` = the merged weights' sum, factor
    column ``-w/ℓ_kk``, then one inverse-CDF partner per neighbour but the
    heaviest, each sampled edge weighted ``S[i+1]·w_i/ℓ_kk``.  Weights
    are in ``ws.dtype``; ``u`` is float32."""
    R, W = ids.shape
    dev, dt = ids.device, ws.dtype
    pos = torch.arange(W, dtype=torch.int64, device=dev)[None, :]
    ids = torch.where(valid, ids, INVALID_ID).to(torch.int32)
    ws = torch.where(valid, ws, torch.zeros((), dtype=dt, device=dev))
    # merge parallel edges
    o = _lexsort2(ids, ws)
    ids_s, ws_s = torch.gather(ids, 1, o), torch.gather(ws, 1, o)
    is_start = torch.cat([torch.ones((R, 1), dtype=torch.bool, device=dev),
                          ids_s[:, 1:] != ids_s[:, :-1]], dim=1)
    is_start &= ids_s != INVALID_ID
    cs = _hs_cumsum(ws_s)
    nvalid = (ids_s != INVALID_ID).sum(dim=1)
    run_end = torch.searchsorted(ids_s.contiguous(), ids_s.contiguous(),
                                 right=True).to(torch.int64) - 1
    run_end = torch.minimum(run_end, (nvalid - 1).clamp(min=0)[:, None])
    prev_cs = torch.where(pos > 0, torch.gather(
        cs, 1, (pos - 1).clamp(min=0).expand(R, -1)),
        torch.zeros((), dtype=dt, device=dev))
    run_sum = torch.gather(cs, 1, run_end) - prev_cs
    merged_id = torch.where(is_start, ids_s, INVALID_ID)
    merged_w = torch.where(is_start, run_sum,
                           torch.zeros((), dtype=dt, device=dev))
    m = is_start.sum(dim=1).to(torch.int32)
    ell_kk = torch.where(nvalid > 0, torch.gather(
        cs, 1, (nvalid - 1).clamp(min=0)[:, None])[:, 0],
        torch.zeros((), dtype=dt, device=dev))
    o = torch.argsort(merged_id, dim=1, stable=True)
    g_rows = torch.gather(merged_id, 1, o)
    g_w = torch.gather(merged_w, 1, o)
    one = torch.ones((), dtype=dt, device=dev)
    safe_ell = torch.where(ell_kk > 0, ell_kk, one)[:, None]
    zero = torch.zeros((), dtype=dt, device=dev)
    g_vals = torch.where(g_rows != INVALID_ID, -g_w / safe_ell, zero)
    # sort by (w, id), invalid lanes first; suffix sums
    sort_w = torch.where(g_rows != INVALID_ID, g_w,
                         torch.full((), float("-inf"), dtype=dt, device=dev))
    o = _lexsort2(sort_w, g_rows)
    sid = torch.gather(g_rows, 1, o)
    sval = torch.where(sid != INVALID_ID, torch.gather(g_w, 1, o), zero)
    S = _hs_suffix_sum(sval)
    S1 = torch.cat([S[:, 1:], torch.zeros((R, 1), dtype=dt, device=dev)],
                   dim=1)
    # inverse-CDF spanning-tree sampling; the threshold S1 - u·S1 is
    # rounded once
    first = (W - m.to(torch.int64))[:, None]
    i_log = (pos - first).clamp(0, W - 1)
    up = torch.gather(u, 1, i_log)
    S1d = S1.double()
    thresh = (S1d - up.double() * S1d).to(dt)
    c = _searchsorted_right(torch.flip(S1, (1,)).contiguous(), thresh)
    j_idx = torch.minimum(torch.maximum(pos + 1, W - c),
                          torch.full_like(c, W - 1))
    e_valid = (pos >= first) & (pos < W - 1) & (m >= 2)[:, None]
    a = sid
    b = torch.gather(sid, 1, j_idx)
    e_lo = torch.where(e_valid, torch.minimum(a, b), INVALID_ID)
    e_hi = torch.where(e_valid, torch.maximum(a, b), INVALID_ID)
    e_w = torch.where(e_valid, S1 * sval / safe_ell, zero)
    return _Elim(g_rows=g_rows.to(torch.int32), g_vals=g_vals, m=m,
                 ell_kk=ell_kk, e_lo=e_lo.to(torch.int32),
                 e_hi=e_hi.to(torch.int32), e_w=e_w, e_valid=e_valid)


# ---------------------------------------------------------------------------
# the factor
# ---------------------------------------------------------------------------

def factor(n: int, src, dst, w, key, *, dtype=torch.float32,
           device="cpu", block_elems: int = 1 << 22) -> Factor:
    """The oracle's factor of the graph ``(n, src, dst, w)`` for ``key``
    (raw ``uint32[2]``), eliminating in rounds every vertex whose bucket
    is final.  A round's buckets go through in blocks of at most
    ``block_elems`` padded slots."""
    dev = torch.device(device)
    lo = torch.as_tensor(np.asarray(src, np.int64), device=dev)
    hi = torch.as_tensor(np.asarray(dst, np.int64), device=dev)
    wt = torch.as_tensor(np.asarray(w, np.float32), device=dev).to(dtype)
    elim = torch.zeros(n, dtype=torch.bool, device=dev)
    D = torch.zeros(n, dtype=dtype, device=dev)
    out_v, out_r, out_x = [], [], []
    done = 0
    while done < n:
        dep = torch.bincount(hi, minlength=n)
        ready = ~elim & (dep == 0)
        verts = torch.nonzero(ready).squeeze(1)
        R = int(verts.numel())
        if R == 0:
            raise RuntimeError(f"reference stalled: {done}/{n} eliminated")
        take = ready[lo]
        t_lo, t_hi, t_w = lo[take], hi[take], wt[take]
        lo, hi, wt = lo[~take], hi[~take], wt[~take]
        order = torch.argsort(t_lo, stable=True)
        t_lo, t_hi, t_w = t_lo[order], t_hi[order], t_w[order]
        cnt = torch.bincount(t_lo, minlength=n)
        start = torch.cumsum(cnt, 0) - cnt
        rank = torch.arange(t_lo.numel(), device=dev) - start[t_lo]
        row_of = torch.full((n,), -1, dtype=torch.int64, device=dev)
        row_of[verts] = torch.arange(R, device=dev)
        e_row = row_of[t_lo]
        fill = cnt[verts]
        W = max(_next_pow2(int(fill.max())), 2)
        step = max(1, block_elems // W)
        new_lo, new_hi, new_w = [], [], []
        for a in range(0, R, step):
            b = min(a + step, R)
            sel = (e_row >= a) & (e_row < b)
            ids = torch.full((b - a, W), INVALID_ID, dtype=torch.int32,
                             device=dev)
            ws = torch.zeros((b - a, W), dtype=dtype, device=dev)
            ids[e_row[sel] - a, rank[sel]] = t_hi[sel].to(torch.int32)
            ws[e_row[sel] - a, rank[sel]] = t_w[sel]
            valid = (torch.arange(W, device=dev)[None, :]
                     < fill[a:b, None])
            res = eliminate(ids, ws, valid,
                            column_uniforms(key, verts[a:b], W))
            D[verts[a:b]] = res.ell_kk
            live = torch.arange(W, device=dev)[None, :] \
                < res.m.to(torch.int64)[:, None]
            out_v.append(verts[a:b, None].expand(-1, W)[live])
            out_r.append(res.g_rows[live])
            out_x.append(res.g_vals[live])
            # a lower precision's non-finite sums can sample past the
            # bucket's last entry; float32 never does (the tests hold it
            # to the oracle bit for bit)
            ev = res.e_valid & (res.e_hi != INVALID_ID)
            new_lo.append(res.e_lo[ev].to(torch.int64))
            new_hi.append(res.e_hi[ev].to(torch.int64))
            new_w.append(res.e_w[ev])
        lo = torch.cat([lo] + new_lo)
        hi = torch.cat([hi] + new_hi)
        wt = torch.cat([wt] + new_w)
        elim[verts] = True
        done += R
    v = torch.cat(out_v)
    order = torch.argsort(v, stable=True)
    col_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(torch.bincount(v, minlength=n).cpu().numpy(),
              out=col_ptr[1:])
    return Factor(col_ptr=col_ptr,
                  rows=torch.cat(out_r)[order].cpu().numpy(),
                  vals=torch.cat(out_x)[order].cpu().float().numpy(),
                  D=D.cpu().float().numpy())


def factor_sequential(n: int, src, dst, w, key) -> Factor:
    """The sequential oracle itself, one vertex at a time in label order
    (small graphs only: the tests hold :func:`factor` to it)."""
    cols = [[] for _ in range(n)]
    for s, d, x in zip(np.asarray(src), np.asarray(dst),
                       np.asarray(w, np.float32)):
        cols[int(s)].append((int(d), np.float32(x)))
    rows, vals, lens = [], [], []
    D = np.zeros(n, np.float32)
    for k in range(n):
        entries, cols[k] = cols[k], None
        d = len(entries)
        if d == 0:
            lens.append(0)
            continue
        W = max(_next_pow2(d), 2)
        ids = torch.full((1, W), INVALID_ID, dtype=torch.int32)
        ws = torch.zeros((1, W), dtype=torch.float32)
        ids[0, :d] = torch.tensor([e[0] for e in entries], dtype=torch.int32)
        ws[0, :d] = torch.tensor([e[1] for e in entries])
        valid = torch.arange(W)[None, :] < d
        res = eliminate(ids, ws, valid,
                        column_uniforms(key, torch.tensor([k]), W))
        m = int(res.m[0])
        D[k] = float(res.ell_kk[0])
        rows.append(res.g_rows[0, :m].numpy())
        vals.append(res.g_vals[0, :m].numpy())
        lens.append(m)
        ev = res.e_valid[0].numpy()
        for a, b, x in zip(res.e_lo[0].numpy()[ev], res.e_hi[0].numpy()[ev],
                           res.e_w[0].numpy()[ev]):
            cols[int(a)].append((int(b), np.float32(x)))
    col_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=col_ptr[1:])
    return Factor(col_ptr=col_ptr,
                  rows=(np.concatenate(rows) if rows
                        else np.zeros(0, np.int32)).astype(np.int32),
                  vals=(np.concatenate(vals) if vals
                        else np.zeros(0, np.float32)).astype(np.float32),
                  D=D)


def factor_mismatch(got, want: Factor) -> int:
    """Entries of ``col_ptr``, ``rows``, ``vals`` and ``D`` whose bits
    differ (0: the same factor).  Arrays of different lengths count
    their longer length."""
    bad = 0
    for name in ("col_ptr", "rows", "vals", "D"):
        a = np.ascontiguousarray(getattr(got, name))
        b = np.ascontiguousarray(getattr(want, name))
        if a.shape != b.shape:
            bad += max(a.size, b.size)
            continue
        if a.dtype.kind == "f":
            a, b = a.astype(np.float32).view(np.int32), \
                b.astype(np.float32).view(np.int32)
        bad += int(np.count_nonzero(a != b))
    return bad


# ---------------------------------------------------------------------------
# the preconditioner apply (G D Gᵀ)⁺ r = G⁻ᵀ D⁺ G⁻¹ r
# ---------------------------------------------------------------------------

def _levels(dep_of: torch.Tensor, on: torch.Tensor, n: int) -> torch.Tensor:
    """Longest-path level of each vertex: ``level[on] = 1 + max
    level[dep_of]`` over the entries, 0 without entries."""
    lev = torch.zeros(n, dtype=torch.int64, device=on.device)
    while True:
        nxt = torch.zeros_like(lev).scatter_reduce(
            0, on, lev[dep_of] + 1, reduce="amax", include_self=True)
        if torch.equal(nxt, lev):
            return lev
        lev = nxt


class Apply:
    """``r -> G⁻ᵀ D⁺ G⁻¹ r`` for columns ``r`` ``(n, k)``, level by level
    in ``dtype`` (float64 for the reference; bfloat16 for the control:
    the factor, the diagonal and every intermediate vector rounded to
    it)."""

    def __init__(self, f: Factor, *, dtype=torch.float64, device="cpu"):
        dev = torch.device(device)
        n = f.D.shape[0]
        col = np.repeat(np.arange(n, dtype=np.int64), np.diff(f.col_ptr))
        self.n, self.dtype = n, dtype
        rows = torch.as_tensor(f.rows.astype(np.int64), device=dev)
        cols = torch.as_tensor(col, device=dev)
        vals = torch.as_tensor(f.vals, device=dev).to(dtype)
        D = torch.as_tensor(f.D, device=dev).to(dtype)
        self.dinv = torch.where(D > 0, 1 / D.double(),
                                0.0).to(dtype)[:, None]
        # forward: y[row] -= G[row, col] · y[col], by the row's level
        self.fwd = self._plan(rows, cols, vals, _levels(cols, rows, n))
        # backward: x[col] -= G[row, col] · x[row], by the column's level
        self.bwd = self._plan(cols, rows, vals, _levels(rows, cols, n))

    @staticmethod
    def _plan(dst, srcs, vals, lev):
        key = lev[dst]
        order = torch.argsort(key, stable=True)
        cnt = torch.bincount(key).cpu().numpy()
        bounds = np.concatenate([[0], np.cumsum(cnt)])
        return dst[order], srcs[order], vals[order], bounds

    @staticmethod
    def _sweep(plan, y):
        dst, srcs, vals, bounds = plan
        for a, b in zip(bounds[:-1], bounds[1:]):
            if b > a:
                y.index_add_(0, dst[a:b],
                             -(vals[a:b, None] * y[srcs[a:b]]))
        return y

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        y = self._sweep(self.fwd, r.to(self.dtype).clone())
        y = y * self.dinv
        return self._sweep(self.bwd, y)


# ---------------------------------------------------------------------------
# the Laplacian and PCG
# ---------------------------------------------------------------------------

class Laplacian:
    """``L X`` for columns ``X`` ``(n, k)`` from the edge list."""

    def __init__(self, n: int, src, dst, w, *, dtype=torch.float64,
                 device="cpu"):
        dev = torch.device(device)
        self.n = n
        self.src = torch.as_tensor(np.asarray(src, np.int64), device=dev)
        self.dst = torch.as_tensor(np.asarray(dst, np.int64), device=dev)
        self.w = torch.as_tensor(np.asarray(w, np.float32),
                                 device=dev).to(dtype)[:, None]

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        X = X.to(self.w.dtype)
        diff = self.w * (X[self.src] - X[self.dst])
        y = torch.zeros_like(X)
        y.index_add_(0, self.src, diff)
        y.index_add_(0, self.dst, -diff)
        return y


def true_relres(lap: Laplacian, X: torch.Tensor, B: torch.Tensor
                ) -> torch.Tensor:
    """``‖L x − b‖ / ‖b‖`` per column in float64, ``b`` projected to mean
    zero (columns of ``X`` and ``B``, ``(n, k)``)."""
    B = B.double()
    B = B - B.mean(dim=0, keepdim=True)
    res = lap(X.double()) - B
    return torch.linalg.vector_norm(res, dim=0) / \
        torch.linalg.vector_norm(B, dim=0).clamp(min=1e-300)


def _project(Y):
    return Y - Y.mean(dim=0, keepdim=True)


class PCGOut(NamedTuple):
    x: torch.Tensor       # (n, k)
    iters: np.ndarray     # int[k]
    relres: np.ndarray    # float[k]


def pcg(lap: Laplacian, precond: Apply, B: torch.Tensor, tol: float,
        maxiter: int, *, dtype=torch.float64) -> PCGOut:
    """Preconditioned CG on every column of ``B`` ``(n, k)`` in ``dtype``,
    the right-hand side, each residual and each preconditioned residual
    kept mean-zero; a column stops once its recursive residual is at most
    ``tol`` of its right-hand side, or after ``maxiter`` iterations."""
    def rd(t):
        return t.to(dtype)

    b = rd(_project(B.double()))
    bnorm = torch.linalg.vector_norm(b.double(), dim=0)
    bnorm = torch.where(bnorm > 0, bnorm, 1.0)
    x = torch.zeros_like(b)
    r = b.clone()
    z = rd(_project(precond(r).double()))
    p = z.clone()
    rz = (r.double() * z.double()).sum(0)
    k = b.shape[1]
    it = torch.zeros(k, dtype=torch.int64, device=b.device)
    active = torch.linalg.vector_norm(r.double(), dim=0) / bnorm > tol
    while bool(active.any()):
        Ap = rd(lap(p))
        pAp = (p.double() * Ap.double()).sum(0)
        alpha = torch.where(active, rz / torch.where(pAp != 0, pAp, 1.0), 0.0)
        xn = rd(x + rd(alpha[None, :]) * p)
        rn = rd(_project((r - rd(alpha[None, :]) * Ap).double()))
        zn = rd(_project(precond(rn).double()))
        rz_new = (rn.double() * zn.double()).sum(0)
        # a column whose update is not finite breaks down: it stops at
        # its last finite iterate (only a lower precision gets there)
        active = active & torch.isfinite(xn).all(0) & \
            torch.isfinite(zn).all(0) & torch.isfinite(rz_new)
        m = active[None, :]
        beta = torch.where(active, rz_new / torch.where(rz != 0, rz, 1.0),
                           0.0)
        x = torch.where(m, xn, x)
        r = torch.where(m, rn, r)
        p = torch.where(m, rd(zn + rd(beta[None, :]) * p), p)
        rz = torch.where(active, rz_new, rz)
        it = it + active.to(torch.int64)
        relres = torch.linalg.vector_norm(r.double(), dim=0) / bnorm
        active = active & (relres > tol) & (it < maxiter)
    relres = torch.linalg.vector_norm(r.double(), dim=0) / bnorm
    return PCGOut(x=x.double(), iters=it.cpu().numpy(),
                  relres=relres.cpu().numpy())


def worst(values) -> float:
    """The largest of ``values``; not a number if any is not one (a
    comparison with a NaN would drop it)."""
    vals = [float(v) for v in values]
    if any(math.isnan(v) for v in vals):
        return float("nan")
    return max(vals, default=0.0)


def apply_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest absolute difference over the largest absolute value of the
    reference, over every column."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp(
        min=1e-300))


def dtype_of(name: Optional[str]):
    return {"float64": torch.float64, "float32": torch.float32,
            "bfloat16": torch.bfloat16}[name or "float64"]
