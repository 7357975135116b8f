"""The plain reference: brute-force exact search in float64.

Imports torch and numpy only, and takes only what the benchmark made:
the raw rows or streams and the raw queries.  It z-normalises every row,
window and query itself (population standard deviation, floored at
1e-8, as the paper's SAX step 1), materialises windows itself, and
scans the whole database in blocks of rows on the given device:

  * range requests: every row with d² ≤ ε² + τ, with its d²;
  * k-NN requests: the ``fetch`` nearest rows, ascending by (d², id).

``precision="tf32"`` is the control: the same scan in float32 with the
inner products taken as tensor cores take them under TF32 (each operand
rounded to 10 mantissa bits, products summed in float32), answering
range requests at ε exactly and k-NN requests by its own nearest rows.
"""
from __future__ import annotations

import numpy as np
import torch

ZNORM_EPS = 1e-8
# The most queries whose distances to one block of rows are held at once:
# (QUERY_CHUNK, block) float64 temporaries, ~1 GiB each at the default
# block, whatever the number of queries.
QUERY_CHUNK = 512


def znorm(x: torch.Tensor) -> torch.Tensor:
    """Z-normalise along the last axis in ``x``'s own dtype."""
    mu = x.mean(dim=-1, keepdim=True)
    dev = x - mu
    sd = dev.pow(2).mean(dim=-1, keepdim=True).sqrt()
    return dev / sd.clamp_min(ZNORM_EPS)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest with ties
    away from zero (``cvt.rna.tf32.f32``)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class RowDatabase:
    """Whole series: row ``i`` is ``rows[i]``."""

    def __init__(self, rows: np.ndarray, device):
        self.rows = rows
        self.device = torch.device(device)
        self.n_rows, self.n = rows.shape

    def block(self, i0: int, i1: int) -> torch.Tensor:
        return torch.as_tensor(self.rows[i0:i1]).to(self.device,
                                                    torch.float64)

    def take(self, ids: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(self.rows[np.asarray(ids, np.int64)]).to(
            self.device, torch.float64)

    def stream_start(self, ids: np.ndarray):
        ids = np.asarray(ids, np.int64)
        return ids, np.zeros_like(ids)


class WindowDatabase:
    """Subsequences: window ``w`` is ``streams[s, a : a + window]`` with
    ``s = w // W_s`` and ``a = (w % W_s) * stride``, W_s windows a
    stream."""

    def __init__(self, streams: np.ndarray, window: int, stride: int,
                 device):
        self.device = torch.device(device)
        self.streams = torch.as_tensor(streams).to(self.device,
                                                   torch.float64)
        S, L = streams.shape
        self.window, self.stride = int(window), int(stride)
        self.per_stream = (L - self.window) // self.stride + 1
        self.n_rows, self.n = S * self.per_stream, self.window

    def stream_start(self, ids: np.ndarray):
        ids = np.asarray(ids, np.int64)
        return ids // self.per_stream, (ids % self.per_stream) * self.stride

    def take(self, ids: np.ndarray) -> torch.Tensor:
        s, a = self.stream_start(ids)
        s = torch.as_tensor(s, device=self.device)
        a = torch.as_tensor(a, device=self.device)
        cols = a[:, None] + torch.arange(self.window, device=self.device)
        return self.streams[s[:, None], cols]

    def block(self, i0: int, i1: int) -> torch.Tensor:
        return self.take(np.arange(i0, i1))


def _d2(zq: torch.Tensor, zx: torch.Tensor, precision: str) -> torch.Tensor:
    """(M, b) squared distances between z-normalised queries and rows."""
    if precision == "tf32":
        dot = round_tf32(zq) @ round_tf32(zx).T
    else:
        dot = zq @ zx.T
    return ((zq * zq).sum(-1)[:, None] + (zx * zx).sum(-1)[None, :]
            - 2.0 * dot).clamp_min(0.0)


def _prepare(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        return znorm(x.to(torch.float32))
    return znorm(x.to(torch.float64))


def scan(db, queries: np.ndarray, is_knn, eps, fetch: int, tau: float,
         precision: str = "f64", block: int = 1 << 18) -> list:
    """One pass over the database for every query.

    Returns, per query, ``(ids int64, d2 float64)``: for a range query
    the rows with d² ≤ ε² + τ (ε² exactly for the control) in id order;
    for a k-NN query the ``fetch`` nearest rows, ascending by (d², id).

    Each block of rows is loaded and z-normalised once; its distances
    are taken for at most ``QUERY_CHUNK`` queries of one kind at a time,
    so the device memory does not grow with the number of queries."""
    dev = db.device
    zq = _prepare(torch.as_tensor(queries).to(dev), precision)
    is_knn = np.asarray(is_knn, bool)
    eps = np.asarray(eps, np.float64)
    M = zq.shape[0]
    knn_rows = np.flatnonzero(is_knn)
    rng_rows = np.flatnonzero(~is_knn)
    lim2 = eps[rng_rows] ** 2 + (0.0 if precision == "tf32" else tau)
    lim2 = torch.as_tensor(lim2, device=dev)[:, None]
    zr = zq[torch.as_tensor(rng_rows, device=dev)]
    zk = zq[torch.as_tensor(knn_rows, device=dev)]
    rng_chunks = _chunks(rng_rows.size)
    knn_chunks = _chunks(knn_rows.size)
    hits = []                      # (range query, row, d2) per block, chunk
    kf = min(int(fetch), db.n_rows)
    best = [None] * len(knn_chunks)       # (d2, ids) of each k-NN chunk
    for i0 in range(0, db.n_rows, block):
        i1 = min(i0 + block, db.n_rows)
        zx = _prepare(db.block(i0, i1), precision)
        for c in rng_chunks:
            d2 = _d2(zr[c], zx, precision)
            qi, ri = torch.nonzero(d2 <= lim2[c].to(d2.dtype),
                                   as_tuple=True)
            hits.append(((qi + c.start).cpu().numpy(),
                         (ri + i0).cpu().numpy(),
                         d2[qi, ri].double().cpu().numpy()))
            del d2
        for j, c in enumerate(knn_chunks):
            d2 = _d2(zk[c], zx, precision).double()
            best[j] = _fold_nearest(best[j], d2, i0, kf)
            del d2
        del zx
    out: list = [None] * M
    if rng_rows.size:
        qi = np.concatenate([h[0] for h in hits])
        ri = np.concatenate([h[1] for h in hits])
        dd = np.concatenate([h[2] for h in hits])
        order = np.lexsort((ri, qi))
        qi, ri, dd = qi[order], ri[order], dd[order]
        cuts = np.searchsorted(qi, np.arange(rng_rows.size + 1))
        for j, q in enumerate(rng_rows):
            sl = slice(cuts[j], cuts[j + 1])
            out[q] = (ri[sl].astype(np.int64), dd[sl])
    if knn_rows.size:
        bd = np.concatenate([b[0].cpu().numpy() for b in best])
        bi = np.concatenate([b[1].cpu().numpy() for b in best])
        for j, q in enumerate(knn_rows):
            order = np.lexsort((bi[j], bd[j]))
            out[q] = (bi[j][order].astype(np.int64), bd[j][order])
    return out


def _chunks(m: int) -> list:
    """Slices of at most ``QUERY_CHUNK`` over ``m`` queries."""
    return [slice(c, min(c + QUERY_CHUNK, m))
            for c in range(0, m, QUERY_CHUNK)]


def _fold_nearest(best, d2: torch.Tensor, i0: int, kf: int) -> tuple:
    """``best`` (the ``kf`` nearest so far, or None) with the block of
    rows from ``i0`` on, whose d² is ``d2``, folded in."""
    vals, idx = torch.topk(d2, min(kf, d2.shape[1]), dim=-1, largest=False)
    idx = idx + i0
    if best is None:
        return vals, idx
    vals = torch.cat([best[0], vals], dim=-1)
    idx = torch.cat([best[1], idx], dim=-1)
    # Ties to the lowest id: order by (d², id) before cutting.
    order = np.lexsort((idx.cpu().numpy(), vals.cpu().numpy()))
    order = torch.as_tensor(order[:, :kf], device=vals.device)
    return torch.gather(vals, -1, order), torch.gather(idx, -1, order)


def distances_sq(db, query: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """float64 squared distances from one raw query to the rows ``ids``."""
    ids = np.asarray(ids, np.int64)
    if ids.size == 0:
        return np.zeros(0)
    zq = znorm(torch.as_tensor(query).to(db.device, torch.float64)[None])
    zx = znorm(db.take(ids))
    return _d2(zq, zx, "f64")[0].cpu().numpy()


def exclusion_greedy(ids: np.ndarray, d: np.ndarray, stream, start,
                     k: int, excl: int) -> tuple:
    """The k nearest windows, no two on one stream starting fewer than
    ``excl`` positions apart: keep candidates in ascending (d², id) order
    unless a kept window is that close.  ``stream`` / ``start``: each
    candidate's stream and start."""
    kept = []
    for j in range(len(ids)):
        if len(kept) == k:
            break
        if any(stream[j] == stream[m] and abs(int(start[j]) - int(start[m]))
               < excl for m in kept):
            continue
        kept.append(j)
    kept = np.asarray(kept, np.int64)
    return np.asarray(ids)[kept], np.asarray(d)[kept]
