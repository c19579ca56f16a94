"""Per-column elimination math (paper Algorithm 2 / Algorithm 4 lines
14-23), batched over rows: the plain PyTorch version of the
``sample_clique`` kernel and the oracle it is held to bit for bit.

For every row (one vertex's padded incident multi-edge list):

  * merge parallel edges with the same neighbour id (sort by (id, w),
    run sums),
  * ℓ_kk = Σ merged weights,
  * sort neighbours ascending by (w, id), invalid lanes first,
  * suffix sums S[i] = Σ_{g≥i} w_g,
  * for each position i < m-1 inverse-CDF sample a partner j > i with
    probability w_j / S[i+1] and emit the spanning-tree edge (id_i, id_j)
    with weight S[i+1]·w_i/ℓ_kk.

Bit-identity with the reference rests on three choices made here:

* Hillis–Steele scans (``hs_cumsum``): the bracketing of position i
  depends on i alone, so any padding width gives the same bits.
* ``thresh = S1 - u·S1`` has ONE rounding, as XLA:CPU contracts it into a
  fused multiply-add: the plain version computes it in float64 and rounds
  once, the kernel writes ``__fmaf_rn(-u, S1, S1)``.
* the partner search is the fixed-trip binary search of
  ``jnp.searchsorted(method="scan", side="right")``, probe for probe, so
  even an S1 that is not monotone by an ulp gives the reference's answer.

Randomness: slot i of vertex v uses ``uniform(fold_in(fold_in(key, v), i))``
of JAX's threefry-2x32 (partitionable mode), ported bit for bit below on
int64 tensors holding uint32 values.  A key is the raw ``uint32[2]`` that
``jax.random.key_data`` gives.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

INVALID_ID = 2 ** 31 - 1
_M32 = 0xFFFFFFFF


class ColumnElim(NamedTuple):
    """Batched elimination result, rows of width W: ``g_rows/g_vals``
    left-aligned (positions < m valid), sampled edges right-aligned
    (select with ``e_valid``)."""

    g_rows: torch.Tensor   # int32[R, W] merged neighbour ids, ascending
    g_vals: torch.Tensor   # f32[R, W]   factor values -w/ℓkk
    m: torch.Tensor        # int32[R]    number of merged neighbours
    ell_kk: torch.Tensor   # f32[R]      diagonal D[k]
    e_lo: torch.Tensor     # int32[R, W] sampled edge endpoints, lo < hi
    e_hi: torch.Tensor     # int32[R, W]
    e_w: torch.Tensor      # f32[R, W]   sampled edge weights
    e_valid: torch.Tensor  # bool[R, W]


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


# ---------------------------------------------------------------------------
# threefry-2x32 (JAX's default PRNG, partitionable mode)
# ---------------------------------------------------------------------------

def key_from_seed(seed: int) -> np.ndarray:
    """Raw key of ``jax.random.key(seed)`` under JAX's default 32-bit
    mode: ``[0, seed mod 2**32]``."""
    return np.array([0, int(seed) & _M32], np.uint32)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds on uint32 values held in int64
    tensors (broadcasting); returns the two output words."""
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


def fold_in(k1, k2, data):
    """``jax.random.fold_in``: threefry of the counter pair (0, data)."""
    return threefry2x32(k1, k2, torch.zeros_like(data), data & _M32)


def uniform_from_key(k1, k2) -> torch.Tensor:
    """``jax.random.uniform(key)`` (float32 scalar per key): the xor of
    the two threefry words of counter (0, 0), top 23 bits as mantissa."""
    zero = torch.zeros_like(k1)
    y1, y2 = threefry2x32(k1, k2, zero, zero)
    bits = ((y1 ^ y2) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def column_uniforms(key, vertices: torch.Tensor, width: int,
                    block: int = 1 << 14) -> torch.Tensor:
    """Uniforms ``u[r, i] = uniform(fold_in(fold_in(key, vertices[r]), i))``
    for slots ``i < width``, on ``vertices.device`` — schedule and
    padding independent.  ``key`` is a raw uint32[2]; rows go through in
    blocks to bound the int64 temporaries."""
    k = np.asarray(key, np.uint64).reshape(2)
    k1, k2 = int(k[0]), int(k[1])
    dev = vertices.device
    slots = torch.arange(width, dtype=torch.int64, device=dev)[None, :]
    out = torch.empty((vertices.shape[0], width), dtype=torch.float32,
                      device=dev)
    for lo in range(0, vertices.shape[0], block):
        v = vertices[lo:lo + block].to(torch.int64)[:, None]
        kv1, kv2 = fold_in(torch.full_like(v, k1), torch.full_like(v, k2), v)
        ki1, ki2 = fold_in(kv1.expand(-1, width), kv2.expand(-1, width),
                           slots.expand(v.shape[0], -1))
        out[lo:lo + block] = uniform_from_key(ki1, ki2)
    return out


# ---------------------------------------------------------------------------
# scans, sorts and the partner search
# ---------------------------------------------------------------------------

def hs_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis with index-only bracketing
    (Hillis–Steele over the next power of two): appending padding on the
    right never changes earlier prefixes."""
    w = x.shape[-1]
    n2 = _next_pow2(w)
    x = torch.nn.functional.pad(x, (0, n2 - w))
    k = 1
    while k < n2:
        x = x + torch.nn.functional.pad(x[..., :-k], (k, 0))
        k *= 2
    return x[..., :w]


def hs_suffix_sum(x: torch.Tensor) -> torch.Tensor:
    """Suffix sums with index-from-the-right bracketing (width-independent
    when the valid data is right-aligned)."""
    return torch.flip(hs_cumsum(torch.flip(x, (-1,))), (-1,))


def _lexsort2(k1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """Row-wise permutation sorting ascending by (k1, k2), ties kept in
    lane order — the order of ``lax.sort(..., num_keys=2)`` for keys
    whose ties carry equal payloads."""
    o = torch.argsort(k2, dim=-1, stable=True)
    o2 = torch.argsort(torch.gather(k1, -1, o), dim=-1, stable=True)
    return torch.gather(o, -1, o2)


def searchsorted_right(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Row-wise ``jnp.searchsorted(a, v, side="right")`` by JAX's default
    ``scan`` method: ``ceil(log2(W+1))`` halvings of [low, high) with the
    probe ``v < a[mid]``, returning ``high``.  Reproduced probe for probe
    so a row of ``a`` that is out of order by an ulp answers as in JAX."""
    W = a.shape[-1]
    low = torch.zeros_like(v, dtype=torch.int64)
    high = torch.full_like(low, W)
    for _ in range(int(math.ceil(math.log2(W + 1)))):
        mid = (low + high) // 2
        go_left = v < torch.gather(a, -1, mid)
        low, high = torch.where(go_left, low, mid), torch.where(go_left, mid,
                                                                high)
    return high


# ---------------------------------------------------------------------------
# elimination
# ---------------------------------------------------------------------------

def eliminate_column(ids: torch.Tensor, ws: torch.Tensor, valid: torch.Tensor,
                     u: torch.Tensor) -> ColumnElim:
    """Eliminate R vertices at once, each given its padded incident
    multi-edge list.  ids/ws/valid/u: int32/f32/bool/f32 ``[R, W]``;
    ``u[r, i]`` is the uniform of row r's i-th logical sampling slot."""
    R, W = ids.shape
    dev = ids.device
    pos = torch.arange(W, dtype=torch.int64, device=dev)[None, :]
    ids = torch.where(valid, ids, INVALID_ID).to(torch.int32)
    ws = torch.where(valid, ws, torch.zeros((), dtype=ws.dtype, device=dev))

    # ---- stage 1: merge multi-edges with equal neighbour id -------------
    o = _lexsort2(ids, ws)
    ids_s, ws_s = torch.gather(ids, 1, o), torch.gather(ws, 1, o)
    is_start = torch.cat([torch.ones((R, 1), dtype=torch.bool, device=dev),
                          ids_s[:, 1:] != ids_s[:, :-1]], dim=1)
    is_start &= ids_s != INVALID_ID
    cs = hs_cumsum(ws_s)
    nvalid = (ids_s != INVALID_ID).sum(dim=1)
    # a run ends at the last lane holding its id (ids are sorted)
    run_end = torch.searchsorted(ids_s.contiguous(), ids_s.contiguous(),
                                 right=True).to(torch.int64) - 1
    run_end = torch.minimum(run_end, (nvalid - 1).clamp(min=0)[:, None])
    prev_cs = torch.where(pos > 0, torch.gather(cs, 1, (pos - 1).clamp(min=0)
                                                .expand(R, -1)), 0.0)
    run_sum = torch.gather(cs, 1, run_end) - prev_cs
    merged_id = torch.where(is_start, ids_s, INVALID_ID)
    merged_w = torch.where(is_start, run_sum, 0.0)
    m = is_start.sum(dim=1).to(torch.int32)
    ell_kk = torch.where(nvalid > 0, torch.gather(
        cs, 1, (nvalid - 1).clamp(min=0)[:, None])[:, 0], 0.0)

    # compact merged entries to the front (ids ascending already)
    o = torch.argsort(merged_id, dim=1, stable=True)
    g_rows = torch.gather(merged_id, 1, o)
    g_w = torch.gather(merged_w, 1, o)
    safe_ell = torch.where(ell_kk > 0, ell_kk, 1.0)[:, None]
    g_vals = torch.where(g_rows != INVALID_ID, -g_w / safe_ell, 0.0)

    # ---- stage 2: sort by (w, id), invalid lanes first (−inf key) -------
    sort_w = torch.where(g_rows != INVALID_ID, g_w, float("-inf"))
    o = _lexsort2(sort_w, g_rows)
    sid = torch.gather(g_rows, 1, o)
    sval = torch.where(sid != INVALID_ID, torch.gather(g_w, 1, o), 0.0)
    S = hs_suffix_sum(sval)
    S1 = torch.cat([S[:, 1:], torch.zeros((R, 1), dtype=S.dtype,
                                          device=dev)], dim=1)

    # ---- stage 3: inverse-CDF spanning-tree sampling ---------------------
    first = (W - m.to(torch.int64))[:, None]
    i_log = (pos - first).clamp(0, W - 1)
    up = torch.gather(u, 1, i_log)
    S1d = S1.double()
    thresh = (S1d - up.double() * S1d).float()      # one rounding, as an FMA
    c = searchsorted_right(torch.flip(S1, (1,)).contiguous(), thresh)
    j_idx = torch.minimum(torch.maximum(pos + 1, W - c),
                          torch.full_like(c, W - 1))
    e_valid = (pos >= first) & (pos < W - 1) & (m >= 2)[:, None]
    a = sid
    b = torch.gather(sid, 1, j_idx)
    e_lo = torch.where(e_valid, torch.minimum(a, b), INVALID_ID)
    e_hi = torch.where(e_valid, torch.maximum(a, b), INVALID_ID)
    e_w = torch.where(e_valid, S1 * sval / safe_ell, 0.0)
    return ColumnElim(g_rows=g_rows.to(torch.int32), g_vals=g_vals, m=m,
                      ell_kk=ell_kk, e_lo=e_lo.to(torch.int32),
                      e_hi=e_hi.to(torch.int32), e_w=e_w, e_valid=e_valid)
