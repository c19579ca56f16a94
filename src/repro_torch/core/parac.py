"""ParAC — bulk-synchronous wavefront randomized Cholesky (PyTorch).

Each round of the engine:

  1. the *ready set* (dep == 0, not eliminated) is an independent set of
     the current multi-graph — take the ``chunk`` smallest labels;
  2. gather their column slabs from the static edge pool and eliminate
     them all at once with the ``sample_clique`` kernel;
  3. write the normalized columns back in place (the pool doubles as the
     output factor);
  4. scatter the sampled spanning-tree edges to their owner column's slab
     at sort-derived offsets;
  5. update dependency counters with integer segment adds.

The engine is batched from the start: state tensors carry a leading
graph axis ``B`` (the reference's ``vmap``), and rounds run in a Python
loop (its ``while_loop``) that reads the "anyone still running" flag
every ``check_every`` rounds.  A graph that has finished takes no-op
rounds (no candidate is ready, its round counter does not advance), so
each graph takes exactly its own round sequence, as under the reference's
vmap-of-while freeze.

Every state array has one extra *drop* entry (pool slot ``P``, column
``n``) that absorbs the writes the reference discards with
``mode="drop"``; nothing reads it unmasked.

The factor is bit-identical to the reference engine's and to the
sequential oracle for the same key: per-vertex randomness is schedule
independent (``column_math.column_uniforms``) and the elimination math is
padding-width independent.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .laplacian import Graph
from .column_math import column_uniforms, INVALID_ID, ColumnElim
from .ref_ac import ACFactor, DeviceFactor
from ..kernels import ops
from ..kernels.runtime import resolve_device

I64 = torch.int64


class EngineState(NamedTuple):
    pool_row: torch.Tensor   # int32[B, P+1] max-label endpoint / factor row id
    pool_val: torch.Tensor   # f32[B, P+1]   alive: edge weight; done: G value
    col_fill: torch.Tensor   # int32[B, n+1] entries in each column slab
    dep: torch.Tensor        # int32[B, n+1] alive multi-edges with max endpoint v
    elim: torch.Tensor       # bool[B, n+1]  (the drop column is always True)
    D: torch.Tensor          # f32[B, n+1]
    n_elim: torch.Tensor     # int32[B]
    n_rounds: torch.Tensor   # int32[B]
    overflow: torch.Tensor   # int32[B] dropped sampled edges


class EngineStatic(NamedTuple):
    col_base: torch.Tensor   # int64[B, n+1] slab base (drop column: pool end)
    cap: torch.Tensor        # int32[B, n+1] slab capacity (drop column: 0)
    u: torch.Tensor          # f32[B, n, W] per-(vertex, slot) uniforms
    W: int                   # slab gather width (power of two ≥ 2)
    chunk: int


# ---------------------------------------------------------------------------
# round stages
# ---------------------------------------------------------------------------

def _live(s: EngineState) -> torch.Tensor:
    n = s.elim.shape[1] - 1
    return (s.n_elim < n) & (s.n_rounds <= n)


def _round_ready(elim, dep, live, *, chunk: int):
    """Stage 1 — the ``chunk`` smallest ready labels of every live graph,
    ascending (the candidate order fixes the scatter ranks, hence the
    factor bits).  Short rounds pad with the drop column ``n``."""
    B, n1 = elim.shape
    n = n1 - 1
    ready = (~elim) & (dep == 0) & live[:, None]
    rank = torch.cumsum(ready, dim=1, dtype=I64)
    idx = torch.where(ready & (rank <= chunk), rank - 1, chunk)
    buf = torch.full((B, chunk + 1), n, dtype=I64, device=elim.device)
    labels = torch.arange(n1, dtype=I64, device=elim.device).expand(B, -1)
    buf.scatter_(1, idx, labels)          # slot `chunk` collects the rest
    cand = buf[:, :chunk].contiguous()
    return cand, cand < n


def _round_gather(s: EngineState, st: EngineStatic, cand, cand_ok):
    """Stage 2a — gather the candidates' slabs and uniforms: the inputs
    of the elimination kernel, rows ``[B*chunk, W]``."""
    B, chunk = cand.shape
    W = st.W
    P = s.pool_row.shape[1] - 1
    n = s.elim.shape[1] - 1
    offs = torch.arange(W, dtype=I64, device=cand.device)
    base = torch.gather(st.col_base, 1, cand)
    fill = torch.where(cand_ok, torch.gather(s.col_fill, 1, cand), 0)
    slots = base[:, :, None] + offs
    sv = offs < fill[:, :, None]
    slots_c = torch.where(sv, slots, P).reshape(B, chunk * W)
    ids = torch.where(sv, torch.gather(s.pool_row, 1, slots_c)
                      .view(B, chunk, W), INVALID_ID)
    ws = torch.where(sv, torch.gather(s.pool_val, 1, slots_c)
                     .view(B, chunk, W), 0.0)
    u = torch.gather(st.u, 1, cand.clamp(max=n - 1)[:, :, None]
                     .expand(-1, -1, W))
    return (ids.view(B * chunk, W), ws.view(B * chunk, W),
            fill.view(B * chunk).to(torch.int32), u.view(B * chunk, W),
            slots, sv)


def _round_eliminate(s: EngineState, st: EngineStatic, cand, cand_ok):
    """Stage 2 — eliminate all candidates at once (the kernel)."""
    ids, ws, fill, u, slots, sv = _round_gather(s, st, cand, cand_ok)
    res = ops.sample_clique(ids, ws, fill, u)
    return res, slots, sv, ids


def _round_commit(s: EngineState, cand, cand_ok, res: ColumnElim, slots, sv,
                  ids):
    """Stages 3+4 — write normalized factor columns in place and decrement
    dependency counters for the consumed multi-edges (in place)."""
    B, chunk = cand.shape
    W = slots.shape[2]
    P = s.pool_row.shape[1] - 1
    n = s.elim.shape[1] - 1
    offs = torch.arange(W, dtype=I64, device=cand.device)
    m = res.m.view(B, chunk)
    wmask = (offs < m[:, :, None]) & cand_ok[:, :, None]
    tgt = torch.where(wmask, slots, P).view(B, chunk * W)
    s.pool_row.scatter_(1, tgt, res.g_rows.view(B, chunk * W))
    s.pool_val.scatter_(1, tgt, res.g_vals.view(B, chunk * W))
    s.col_fill.scatter_(1, cand, torch.where(
        cand_ok, m, torch.gather(s.col_fill, 1, cand)))
    s.D.scatter_(1, cand, torch.where(
        cand_ok, res.ell_kk.view(B, chunk), torch.gather(s.D, 1, cand)))
    s.elim.scatter_(1, cand, cand_ok | torch.gather(s.elim, 1, cand))
    dec = torch.where(sv, ids.view(B, chunk, W).to(I64), n).view(B, -1)
    s.dep.scatter_add_(1, dec, torch.full_like(dec, -1, dtype=torch.int32))


def _run_ranks(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its run of equal consecutive keys,
    row-wise (keys sorted along the last axis)."""
    E = sorted_keys.shape[-1]
    eidx = torch.arange(E, dtype=I64, device=sorted_keys.device)
    is_start = torch.ones_like(sorted_keys, dtype=torch.bool)
    is_start[..., 1:] = sorted_keys[..., 1:] != sorted_keys[..., :-1]
    run_start = torch.cummax(torch.where(is_start, eidx, 0), dim=-1).values
    return eidx - run_start


def _round_scatter(s: EngineState, st: EngineStatic, res: ColumnElim,
                   cand_ok):
    """Stage 5 — scatter sampled spanning-tree edges to their owner
    column's slab at stable-sort-derived offsets; edges past a slab's
    capacity are dropped and counted in ``overflow`` (in place)."""
    B, chunk = cand_ok.shape
    W = st.W
    E = chunk * W
    P = s.pool_row.shape[1] - 1
    n = s.elim.shape[1] - 1
    ev = (res.e_valid.view(B, chunk, W) & cand_ok[:, :, None]).view(B, E)
    e_lo = torch.where(ev, res.e_lo.view(B, E).to(I64), n)
    so, order = torch.sort(e_lo, dim=1, stable=True)
    sh = torch.gather(res.e_hi.view(B, E), 1, order)
    sw = torch.gather(res.e_w.view(B, E), 1, order)
    rank = _run_ranks(so)
    valid_e = so < n
    dst_fill = torch.gather(s.col_fill, 1, so).to(I64)
    slot = torch.gather(st.col_base, 1, so) + dst_fill + rank
    fits = valid_e & (dst_fill + rank < torch.gather(st.cap, 1, so))
    s.overflow.add_((valid_e & ~fits).sum(dim=1, dtype=torch.int32))
    tgt = torch.where(fits, slot, P)
    s.pool_row.scatter_(1, tgt, sh)
    s.pool_val.scatter_(1, tgt, sw)
    one = torch.ones_like(so, dtype=torch.int32)
    s.col_fill.scatter_add_(1, torch.where(fits, so, n), one)
    s.dep.scatter_add_(1, torch.where(fits, sh.to(I64), n), one)


def _engine_round(s: EngineState, st: EngineStatic) -> None:
    """One bulk-synchronous round over every graph of the batch (in
    place).  Finished graphs take a no-op round."""
    live = _live(s)
    cand, cand_ok = _round_ready(s.elim, s.dep, live, chunk=st.chunk)
    res, slots, sv, ids = _round_eliminate(s, st, cand, cand_ok)
    _round_commit(s, cand, cand_ok, res, slots, sv, ids)
    _round_scatter(s, st, res, cand_ok)
    s.n_elim.add_(cand_ok.sum(dim=1, dtype=torch.int32))
    s.n_rounds.add_(live.to(torch.int32))


def _run_engine_batched(s: EngineState, st: EngineStatic, *,
                        check_every: int = 8,
                        max_rounds: Optional[int] = None) -> EngineState:
    """Rounds until every graph has finished (or stalled past n rounds),
    reading the device's "still running" flag every ``check_every``
    rounds.  ``max_rounds`` stops early (a partial run, for tests and
    for capturing a real round's kernel inputs)."""
    done = 0
    while max_rounds is None or done < max_rounds:
        k = check_every if max_rounds is None else \
            min(check_every, max_rounds - done)
        for _ in range(k):
            _engine_round(s, st)
        done += k
        if not bool(_live(s).any()):
            break
    return s


# ---------------------------------------------------------------------------
# pools, compaction, drivers
# ---------------------------------------------------------------------------

def _cumcount(keys: np.ndarray, n: int) -> np.ndarray:
    """Occurrence rank of each element within its key group."""
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    start = np.concatenate([[True], sk[1:] != sk[:-1]])
    run_start = np.maximum.accumulate(np.where(start, np.arange(sk.size), 0))
    rank_sorted = np.arange(sk.size) - run_start
    rank = np.empty_like(rank_sorted)
    rank[order] = rank_sorted
    return rank


def _build_pool(g: Graph, fill_slack: int, dtype):
    """Static slab layout: cap_k = owned-initial-degree + fill_slack."""
    n = g.n
    owned = np.zeros(n, np.int64)
    np.add.at(owned, g.src, 1)
    cap = owned + fill_slack
    col_base = np.zeros(n + 1, np.int64)
    np.cumsum(cap, out=col_base[1:])
    P = int(col_base[-1])
    pool_row = np.full(P, INVALID_ID, np.int32)
    pool_val = np.zeros(P, dtype)
    idx = col_base[g.src] + _cumcount(g.src, n)
    pool_row[idx] = g.dst
    pool_val[idx] = g.w.astype(dtype)
    dep = np.zeros(n, np.int64)
    np.add.at(dep, g.dst, 1)
    dmax = int(cap.max()) if n else 1
    return (pool_row, pool_val, owned.astype(np.int32), dep.astype(np.int32),
            col_base, cap.astype(np.int32), P, dmax)


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def _pad_np(x: np.ndarray, size: int, fill) -> np.ndarray:
    if x.shape[0] == size:
        return x
    return np.concatenate([x, np.full(size - x.shape[0], fill, x.dtype)])


def _init_engine(built, ns, keys, *, n_pad: int, P_pad: int, W: int,
                 chunk: int, device) -> tuple:
    """Stack per-graph pools (padded to ``n_pad`` vertices and ``P_pad``
    slots, plus the drop entries) into the engine's state and statics.
    Phantom vertices ``n..n_pad`` start eliminated."""
    PR, PV, CF, DP, CB, CP, E0 = [], [], [], [], [], [], []
    for (pool_row, pool_val, fill, dep, col_base, cap, P, _), n in zip(built,
                                                                     ns):
        PR.append(_pad_np(pool_row, P_pad + 1, INVALID_ID))
        PV.append(_pad_np(pool_val, P_pad + 1, 0))
        CF.append(_pad_np(fill, n_pad + 1, 0))
        DP.append(_pad_np(dep, n_pad + 1, 0))
        CB.append(_pad_np(col_base, n_pad + 1, col_base[-1]))
        CP.append(_pad_np(cap, n_pad + 1, 0))
        e0 = np.zeros(n_pad + 1, bool)
        e0[n:] = True
        E0.append(e0)
    B = len(built)

    def dev(xs):
        return torch.from_numpy(np.stack(xs)).to(device)

    elim = dev(E0)
    s = EngineState(
        pool_row=dev(PR), pool_val=dev(PV), col_fill=dev(CF), dep=dev(DP),
        elim=elim,
        D=torch.zeros((B, n_pad + 1), dtype=torch.float32, device=device),
        n_elim=(elim[:, :n_pad].sum(dim=1, dtype=torch.int32)),
        n_rounds=torch.zeros(B, dtype=torch.int32, device=device),
        overflow=torch.zeros(B, dtype=torch.int32, device=device))
    u = torch.zeros((B, n_pad, W), dtype=torch.float32, device=device)
    for b, (n, key) in enumerate(zip(ns, keys)):
        u[b, :n] = column_uniforms(
            key, torch.arange(n, dtype=torch.int32, device=device), W)
    st = EngineStatic(col_base=dev(CB), cap=dev(CP), u=u, W=W, chunk=chunk)
    return s, st


def _finalize_factor(g: Graph, s: EngineState, st: EngineStatic, b: int, *,
                     n_phantom: int = 0, stats: dict) -> ACFactor:
    """Compact graph ``b``'s pool into CSC on the device (each column's
    live slab prefix, gathered in column order) and wrap it as an
    ``ACFactor`` whose ``device`` view stays on the device."""
    n = g.n
    eliminated = int(s.n_elim[b]) - n_phantom
    if eliminated != n:
        raise RuntimeError(f"engine stalled: {eliminated}/{n} eliminated "
                           f"(overflow={int(s.overflow[b])})")
    dev = s.pool_row.device
    fill = s.col_fill[b, :n].to(I64)
    col_ptr = torch.zeros(n + 1, dtype=I64, device=dev)
    torch.cumsum(fill, 0, out=col_ptr[1:])
    nnz = int(col_ptr[n])
    t = torch.arange(nnz, dtype=I64, device=dev)
    owner = torch.searchsorted(col_ptr[1:], t, right=True)
    src = st.col_base[b, owner] + (t - col_ptr[owner])
    df = DeviceFactor(col_ptr=col_ptr.to(torch.int32),
                      rows=s.pool_row[b, src].contiguous(),
                      vals=s.pool_val[b, src].contiguous(),
                      D=s.D[b, :n].contiguous())
    return ACFactor(n=n, col_ptr=df.col_ptr.cpu().numpy().astype(np.int64),
                    rows=df.rows.cpu().numpy(), vals=df.vals.cpu().numpy(),
                    D=df.D.cpu().numpy(), stats=stats, device=df)


def _as_keys(keys, B: int) -> List[np.ndarray]:
    ks = [np.asarray(k, np.uint32).reshape(2) for k in
          (np.asarray(keys, np.uint32).reshape(-1, 2)
           if not isinstance(keys, (list, tuple)) else keys)]
    if len(ks) != B:
        raise ValueError(f"got {B} graphs but {len(ks)} keys")
    return ks


def factorize_wavefront(g: Graph, key, *, chunk: int = 64,
                        fill_slack: int = 32, strict: bool = True,
                        max_retries: int = 3, dtype=np.float32,
                        device=None) -> ACFactor:
    """Parallel ParAC factorization of one graph on ``device`` (the GPU
    unless the CPU is asked for).  Bit-identical to the sequential oracle
    for the same key when nothing overflows; ``strict`` retries with a
    doubled slack while sampled edges are dropped."""
    device = resolve_device(device)
    n = g.n
    slack = fill_slack
    ck = min(chunk, max(n, 1))
    for attempt in range(max_retries + 1):
        built = _build_pool(g, slack, dtype)
        P, dmax = built[6], built[7]
        s, st = _init_engine([built], [n], [np.asarray(key, np.uint32)],
                             n_pad=n, P_pad=P,
                             W=max(_next_pow2(dmax), 2), chunk=ck,
                             device=device)
        _run_engine_batched(s, st)
        ovf = int(s.overflow[0])
        if ovf == 0 or not strict or attempt == max_retries:
            break
        slack *= 2
    stats = dict(rounds=int(s.n_rounds[0]), overflow=ovf, chunk=chunk,
                 fill_slack=slack, pool_size=P, dmax=dmax)
    return _finalize_factor(g, s, st, 0, stats=stats)


def factorize_batched(gs: Sequence[Graph], keys, *, chunk: int = 64,
                      fill_slack: int = 32, strict: bool = True,
                      max_retries: int = 3, dtype=np.float32,
                      bucket: bool = True, with_schedules: bool = False,
                      device=None):
    """Factor a fleet of Laplacians concurrently in one batched engine.

    Pools are padded to a common shape bucket (powers of two when
    ``bucket``): phantom vertices start eliminated and phantom pool slots
    belong to zero-capacity columns, so each factor is bit-identical to
    ``factorize_wavefront(g, key, ...)``.  Overflow is handled per graph:
    converged graphs keep their factor while the overflowing subset
    re-runs at doubled slack.  With ``with_schedules`` the fleet's
    triangular level schedules are derived in one batched pass too and
    the call returns ``(factors, schedules)``."""
    device = resolve_device(device)
    gs = list(gs)
    B = len(gs)
    ks = _as_keys(keys, B)
    if B == 0:
        return ([], []) if with_schedules else []
    slacks = [fill_slack] * B
    results: List[Optional[ACFactor]] = [None] * B
    pending = list(range(B))
    for attempt in range(max_retries + 1):
        built = {i: _build_pool(gs[i], slacks[i], dtype) for i in pending}
        n_pad = max(max(gs[i].n for i in pending), 1)
        P_pad = max(max(built[i][6] for i in pending), 1)
        dmax_pad = max(built[i][7] for i in pending)
        if bucket:
            n_pad = _next_pow2(n_pad)
            P_pad = _next_pow2(P_pad)
            dmax_pad = _next_pow2(dmax_pad)
        chunk_eff = min(chunk, n_pad)
        s, st = _init_engine([built[i] for i in pending],
                             [gs[i].n for i in pending],
                             [ks[i] for i in pending], n_pad=n_pad,
                             P_pad=P_pad, W=max(_next_pow2(dmax_pad), 2),
                             chunk=chunk_eff, device=device)
        _run_engine_batched(s, st)
        ovfs = s.overflow.tolist()
        retry = []
        for bi, i in enumerate(pending):
            ovf = ovfs[bi]
            if ovf == 0 or not strict or attempt == max_retries:
                stats = dict(rounds=int(s.n_rounds[bi]), overflow=ovf,
                             chunk=chunk, fill_slack=slacks[i],
                             pool_size=int(built[i][6]),
                             dmax=int(built[i][7]), batched=True,
                             batch_size=len(pending), n_pad=n_pad,
                             P_pad=P_pad, dmax_pad=dmax_pad)
                results[i] = _finalize_factor(gs[i], s, st, bi,
                                              n_phantom=n_pad - gs[i].n,
                                              stats=stats)
            else:
                slacks[i] *= 2
                retry.append(i)
        pending = retry
        if not pending:
            break
    if not with_schedules:
        return results
    from .trisolve import build_schedules_batched
    return results, build_schedules_batched([f.device for f in results])
