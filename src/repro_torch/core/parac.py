"""ParAC — bulk-synchronous wavefront randomized Cholesky (PyTorch).

Each round of the engine:

  1. the *ready set* (dep == 0, not eliminated) is an independent set of
     the current multi-graph — take the ``chunk`` smallest labels;
  2. gather their column slabs from the static edge pool and eliminate
     them all at once;
  3. write the normalized columns back in place (the pool doubles as the
     output factor) — stages 2 and 3 are one launch of the fused
     ``sample_clique`` round kernel on the GPU
     (``kernels.sample_clique.eliminate_round``);
  4. scatter the sampled spanning-tree edges to their owner column's slab
     at sort-derived offsets;
  5. update dependency counters with integer segment adds.

The engine is batched from the start: state tensors carry a leading
graph axis ``B`` (the reference's ``vmap``), and rounds run in a Python
loop (its ``while_loop``) that reads the "anyone still running" flag
every ``check_every`` rounds.  A graph that has finished takes no-op
rounds (no candidate is ready, its round counter does not advance), so
each graph takes exactly its own round sequence, as under the reference's
vmap-of-while freeze.  An attempt under ``strict`` that can still be
retried freezes a graph at its first dropped edge as well, so a discarded
attempt stops within ``check_every`` rounds of its first overflow; the
attempt whose factor is kept runs exactly as the reference's.

Every state array has one extra *drop* entry (pool slot ``P``, column
``n``) that absorbs the writes the reference discards with
``mode="drop"``; nothing reads it unmasked.

The pools are written on the device: a graph's edges are uploaded once a
call, in pool order (:class:`PoolEdges`), and each strict rung fills its
stacked slabs with one scatter of them, so no array of pool slots exists
on the host and none crosses to the device.

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
from .column_math import column_uniforms, INVALID_ID
from .ref_ac import ACFactor, DeviceFactor
from ..kernels.runtime import resolve_device
from ..kernels import sample_clique as _sc
from ..obs.tracing import span

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
    # a graph freezes (takes no-op rounds) at its first dropped edge: a
    # strict attempt that will be retried stops there
    freeze_on_overflow: bool = False


# ---------------------------------------------------------------------------
# round stages
# ---------------------------------------------------------------------------

def _live(s: EngineState, st: EngineStatic) -> torch.Tensor:
    """Graphs still running: not all eliminated, not stalled past n rounds
    and, under ``st.freeze_on_overflow``, nothing dropped yet."""
    n = s.elim.shape[1] - 1
    live = (s.n_elim < n) & (s.n_rounds <= n)
    if st.freeze_on_overflow:
        live &= s.overflow == 0
    return live


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


def _run_ranks(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its run of equal consecutive keys,
    row-wise (keys sorted along the last axis)."""
    E = sorted_keys.shape[-1]
    eidx = torch.arange(E, dtype=I64, device=sorted_keys.device)
    is_start = torch.ones_like(sorted_keys, dtype=torch.bool)
    is_start[..., 1:] = sorted_keys[..., 1:] != sorted_keys[..., :-1]
    run_start = torch.cummax(torch.where(is_start, eidx, 0), dim=-1).values
    return eidx - run_start


def _round_scatter(s: EngineState, st: EngineStatic, res: _sc.RoundEdges,
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
    live = _live(s, st)
    cand, cand_ok = _round_ready(s.elim, s.dep, live, chunk=st.chunk)
    edges = _sc.eliminate_round(s, st, cand, cand_ok)
    _round_scatter(s, st, edges, cand_ok)
    s.n_elim.add_(cand_ok.sum(dim=1, dtype=torch.int32))
    s.n_rounds.add_(live.to(torch.int32))


def _run_engine_batched(s: EngineState, st: EngineStatic, *,
                        check_every: int = 8,
                        max_rounds: Optional[int] = None) -> int:
    """Rounds until every graph has finished, stalled past n rounds or
    frozen by an overflow, reading the device's "still running" flag
    every ``check_every`` rounds (one host read).
    ``max_rounds`` stops early (a partial run, for tests and for
    capturing a real round's kernel inputs).  Returns the rounds run."""
    done = 0
    with span("parac.rounds"):
        while max_rounds is None or done < max_rounds:
            k = check_every if max_rounds is None else \
                min(check_every, max_rounds - done)
            for _ in range(k):
                _engine_round(s, st)
            done += k
            with span("parac.check"):
                live = bool(_live(s, st).any())
            if not live:
                break
    return done


# ---------------------------------------------------------------------------
# pools, compaction, drivers
# ---------------------------------------------------------------------------

class PoolEdges(NamedTuple):
    """One graph's initial edges on the device, in pool order: stably
    sorted by their owner column ``src``, so that with ``owned[v] +
    slack`` slots a column, edge ``i`` sits at slot ``i + slack·src[i]``
    (its column's base plus its rank among the column's edges) whatever
    the slack.  Uploaded once a call and reused by every strict rung."""
    n: int
    src: torch.Tensor    # int64[m] owner column (min endpoint), ascending
    dst: torch.Tensor    # int32[m] max endpoint
    w: torch.Tensor      # [m] weight in the pool's dtype
    owned: torch.Tensor  # int32[n] initial edges of each column
    dep: torch.Tensor    # int32[n] initial edges whose max endpoint is v
    owned_max: int       # largest entry of ``owned`` (0 without edges)


class Pool(NamedTuple):
    """Static slab layout of one rung: cap_k = owned-initial-degree +
    ``slack``; ``P`` slots in all, ``dmax`` the largest capacity."""
    edges: PoolEdges
    slack: int
    P: int
    dmax: int


def _pool_edges(g: Graph, dtype, device) -> PoolEdges:
    """Upload ``g``'s edges (12 B an edge) and order them into the pool
    on ``device``."""
    n = g.n
    src = torch.from_numpy(np.ascontiguousarray(g.src, np.int32)).to(device)
    dst = torch.from_numpy(np.ascontiguousarray(g.dst, np.int32)).to(device)
    w = torch.from_numpy(np.asarray(g.w).astype(dtype)).to(device)
    src, order = torch.sort(src, stable=True)
    owned = torch.bincount(src, minlength=n).to(torch.int32)
    dep = torch.bincount(dst, minlength=n).to(torch.int32)
    return PoolEdges(n=n, src=src.to(I64), dst=dst[order], w=w[order],
                     owned=owned, dep=dep,
                     owned_max=int(owned.max()) if n else 0)


def _build_pool(e: PoolEdges, fill_slack: int) -> Pool:
    P = e.src.shape[0] + e.n * fill_slack
    return Pool(edges=e, slack=fill_slack, P=P,
                dmax=e.owned_max + fill_slack if e.n else 1)


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def _init_engine(pools: Sequence[Pool], keys, *, n_pad: int, P_pad: int,
                 W: int, chunk: int, freeze_on_overflow: bool = False
                 ) -> tuple:
    """Write the engine's state and statics for ``pools`` on their edges'
    device: each graph's slabs padded to ``n_pad`` vertices and ``P_pad``
    slots, plus the drop entries.  Phantom vertices ``n..n_pad`` start
    eliminated with no capacity, and their columns' base is the graph's
    pool end.  The ``parac.init`` span's ``h2d_bytes`` counts what this
    copies from the host: a graph's size and slack, whatever its pool's."""
    device = pools[0].edges.src.device
    B = len(pools)
    with span("parac.init") as sp:
        meta = torch.tensor([[p.edges.n, p.slack] for p in pools], dtype=I64)
        if sp:
            sp.set(h2d_bytes=meta.numel() * meta.element_size())
        meta = meta.to(device)
        pool_row = torch.full((B, P_pad + 1), INVALID_ID, dtype=torch.int32,
                              device=device)
        pool_val = torch.zeros((B, P_pad + 1), dtype=pools[0].edges.w.dtype,
                               device=device)
        col_fill = torch.zeros((B, n_pad + 1), dtype=torch.int32,
                               device=device)
        dep = torch.zeros_like(col_fill)
        for b, p in enumerate(pools):
            e = p.edges
            slot = e.src * p.slack + torch.arange(e.src.shape[0], dtype=I64,
                                                  device=device)
            pool_row[b].index_copy_(0, slot, e.dst)
            pool_val[b].index_copy_(0, slot, e.w)
            col_fill[b, :e.n] = e.owned
            dep[b, :e.n] = e.dep
        live = torch.arange(n_pad + 1, dtype=I64, device=device) < meta[:, :1]
        cap = torch.where(live, col_fill + meta[:, 1:].to(torch.int32), 0)
        col_base = torch.zeros((B, n_pad + 1), dtype=I64, device=device)
        col_base[:, 1:] = torch.cumsum(cap[:, :n_pad], dim=1, dtype=I64)
        elim = ~live
        s = EngineState(
            pool_row=pool_row, pool_val=pool_val, col_fill=col_fill, dep=dep,
            elim=elim,
            D=torch.zeros((B, n_pad + 1), dtype=torch.float32, device=device),
            n_elim=elim[:, :n_pad].sum(dim=1, dtype=torch.int32),
            n_rounds=torch.zeros(B, dtype=torch.int32, device=device),
            overflow=torch.zeros(B, dtype=torch.int32, device=device))
        u = torch.zeros((B, n_pad, W), dtype=torch.float32, device=device)
        for b, (p, key) in enumerate(zip(pools, keys)):
            n = p.edges.n
            u[b, :n] = column_uniforms(
                key, torch.arange(n, dtype=torch.int32, device=device), W)
        st = EngineStatic(col_base=col_base, cap=cap, u=u, W=W, chunk=chunk,
                          freeze_on_overflow=freeze_on_overflow)
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
    doubled slack while sampled edges are dropped, stopping an attempt it
    will retry within ``check_every`` rounds of its first drop."""
    device = resolve_device(device)
    n = g.n
    slack = fill_slack
    ck = min(chunk, max(n, 1))
    edges = None
    for attempt in range(max_retries + 1):
        with span("parac.attempt") as sp:
            with span("parac.pools") as sp_pools:
                if sp_pools:
                    sp_pools.set(edges_uploaded=0 if edges else g.m)
                edges = edges or _pool_edges(g, dtype, device)
                built = _build_pool(edges, slack)
            P, dmax = built.P, built.dmax
            W = max(_next_pow2(dmax), 2)
            s, st = _init_engine([built], [np.asarray(key, np.uint32)],
                                 n_pad=n, P_pad=P, W=W, chunk=ck,
                                 freeze_on_overflow=strict
                                 and attempt < max_retries)
            launched = _run_engine_batched(s, st)
            ovf = int(s.overflow[0])
            kept = ovf == 0 or not strict or attempt == max_retries
            if sp:
                sp.set(attempt=attempt, members=1, slack=slack, W=W,
                       rounds=int(s.n_rounds[0]), launched=launched,
                       overflow=ovf, kept=int(kept))
            if kept:
                stats = dict(rounds=int(s.n_rounds[0]), overflow=ovf,
                             chunk=chunk, fill_slack=slack, pool_size=P,
                             dmax=dmax)
                with span("parac.finalize"):
                    return _finalize_factor(g, s, st, 0, stats=stats)
        slack *= 2


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
    re-runs at doubled slack; in an attempt that can still be retried a
    graph freezes at its first dropped edge while the others run on.
    With ``with_schedules`` the fleet's triangular level schedules are
    derived in one batched pass too and the call returns ``(factors,
    schedules)``."""
    device = resolve_device(device)
    gs = list(gs)
    B = len(gs)
    ks = _as_keys(keys, B)
    if B == 0:
        return ([], []) if with_schedules else []
    slacks = [fill_slack] * B
    results: List[Optional[ACFactor]] = [None] * B
    pending = list(range(B))
    edges = {}
    for attempt in range(max_retries + 1):
        with span("parac.attempt") as sp:
            with span("parac.pools") as sp_pools:
                new = [i for i in pending if i not in edges]
                edges.update((i, _pool_edges(gs[i], dtype, device))
                             for i in new)
                built = {i: _build_pool(edges[i], slacks[i])
                         for i in pending}
                if sp_pools:
                    sp_pools.set(edges_uploaded=sum(gs[i].m for i in new))
            n_pad = max(max(gs[i].n for i in pending), 1)
            P_pad = max(max(built[i].P for i in pending), 1)
            dmax_pad = max(built[i].dmax for i in pending)
            if bucket:
                n_pad = _next_pow2(n_pad)
                P_pad = _next_pow2(P_pad)
                dmax_pad = _next_pow2(dmax_pad)
            chunk_eff = min(chunk, n_pad)
            W = max(_next_pow2(dmax_pad), 2)
            s, st = _init_engine([built[i] for i in pending],
                                 [ks[i] for i in pending], n_pad=n_pad,
                                 P_pad=P_pad, W=W, chunk=chunk_eff,
                                 freeze_on_overflow=strict
                                 and attempt < max_retries)
            launched = _run_engine_batched(s, st)
            ovfs = s.overflow.tolist()
            retry = []
            for bi, i in enumerate(pending):
                ovf = ovfs[bi]
                if ovf == 0 or not strict or attempt == max_retries:
                    stats = dict(rounds=int(s.n_rounds[bi]), overflow=ovf,
                                 chunk=chunk, fill_slack=slacks[i],
                                 pool_size=built[i].P,
                                 dmax=built[i].dmax, batched=True,
                                 batch_size=len(pending), n_pad=n_pad,
                                 P_pad=P_pad, dmax_pad=dmax_pad)
                    with span("parac.finalize"):
                        results[i] = _finalize_factor(
                            gs[i], s, st, bi, n_phantom=n_pad - gs[i].n,
                            stats=stats)
                else:
                    retry.append(i)
            if sp:
                # the rounds of the members that dropped an edge (where a
                # frozen one stopped), else of the whole rung
                over = s.overflow > 0
                rounds = s.n_rounds[over] if bool(over.any()) else s.n_rounds
                sp.set(attempt=attempt, members=len(pending),
                       slack=slacks[pending[0]], W=W,
                       rounds=int(rounds.max()), launched=launched,
                       overflow=sum(ovfs), kept=len(pending) - len(retry))
        for i in retry:
            slacks[i] *= 2
        pending = retry
        if not pending:
            break
    if not with_schedules:
        return results
    from .trisolve import build_schedules_batched
    return results, build_schedules_batched([f.device for f in results])
