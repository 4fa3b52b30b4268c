"""Feature-index retrieval: exact k-NN (kernel K3 ``knn_topk``), the
inverse-square-distance blend, and the k-means that compresses an index.

Port of ``rvc_tpu/ops/retrieval.py`` (``knn_search``, ``knn_search_tiled``,
``retrieve_blend``, ``FeatureIndex``, ``kmeans``) with the k-NN routed to
the hand-written kernel in ``csrc/knn.cu``, the counterpart of
``ops/retrieval_pallas.py``'s ``knn_search_pallas``. Every search on a CUDA
tensor goes through the kernel, k-means' assignment step included (K3 at
k = 1); for CPU tensors the plain versions run: ``knn_search_plain``, or
``knn_search_tiled`` where the dense [T, N] distance matrix would be large.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import H100_SMS, resolve_device

launches = {"knn_topk": 0}
MAX_K = 8
_QB, _VB = 128, 128  # queries per block and index rows per tile (csrc/knn.cu)


def reset_launches() -> None:
    launches["knn_topk"] = 0


def knn_search_plain(queries: torch.Tensor, vectors: torch.Tensor,
                     k: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN by squared L2: queries [T, D], vectors [N, D] ->
    (distances [T, k] ascending and clamped to >= 0, indices [T, k]). At
    k = 1 a tie goes to the lower index, as in the kernel."""
    q2 = torch.sum(queries ** 2, dim=1, keepdim=True)
    v2 = torch.sum(vectors ** 2, dim=1)[None, :]
    d2 = q2 + v2 - 2.0 * (queries @ vectors.T)
    if k == 1:
        idx = torch.argmin(d2, dim=1, keepdim=True)
        return torch.clamp(torch.gather(d2, 1, idx), min=0.0), idx
    neg, idx = torch.topk(-d2, k, dim=1, sorted=True)
    return torch.clamp(-neg, min=0.0), idx


def knn_search_tiled(queries: torch.Tensor, vectors: torch.Tensor, k: int = 8,
                     tile: int = 65536) -> Tuple[torch.Tensor, torch.Tensor]:
    """``knn_search_plain`` streamed over ``tile``-row blocks of the index
    with a running top-k, so that the distance matrix held at once is
    [T, tile] and not [T, N]."""
    q2 = torch.sum(queries ** 2, dim=1, keepdim=True)
    best_d = torch.full((queries.shape[0], k), float("inf"), device=queries.device)
    best_i = torch.zeros((queries.shape[0], k), dtype=torch.int64,
                         device=queries.device)
    for start in range(0, vectors.shape[0], tile):
        vt = vectors[start:start + tile]
        d2 = q2 + torch.sum(vt ** 2, dim=1)[None, :] - 2.0 * (queries @ vt.T)
        idx = torch.arange(start, start + vt.shape[0], device=queries.device)
        cat_d = torch.cat([best_d, d2], dim=1)
        cat_i = torch.cat([best_i, idx[None, :].expand(d2.shape[0], -1)], dim=1)
        neg, sel = torch.topk(-cat_d, k, dim=1, sorted=True)
        best_d, best_i = -neg, torch.gather(cat_i, 1, sel)
    return torch.clamp(best_d, min=0.0), best_i


# index row count above which the CPU search streams the index
TILED_SEARCH_THRESHOLD = 200_000
# cap on the elements of a dense [T, N] (or streamed [T, tile]) distance
# matrix on the CPU: 2^27 float32 = 512 MB
DENSE_ELEMS_LIMIT = 1 << 27
MIN_TILE = 4096


def _search_plain(queries: torch.Tensor, vectors: torch.Tensor, k: int):
    """The CPU search: dense where the distance matrix is small, else
    streamed in blocks that keep [T, tile] under the cap."""
    t, n = queries.shape[0], vectors.shape[0]
    if n <= TILED_SEARCH_THRESHOLD and t * n <= DENSE_ELEMS_LIMIT:
        return knn_search_plain(queries, vectors, k)
    tile = int(min(65536, max(MIN_TILE, DENSE_ELEMS_LIMIT // max(t, 1))))
    return knn_search_tiled(queries, vectors, k, tile=tile)


def _lib():
    from ._build import load

    lib = load("knn")
    if not getattr(lib, "_rvc_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rvc_knn_topk.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.rvc_knn_topk.restype = i
        lib._rvc_typed = True
    return lib


def split_plan(n_q: int, n_v: int) -> Tuple[int, int]:
    """(splits of the index, rows per split): contiguous runs of whole
    128-row tiles, as many splits as fill the card's SMs with one block
    each (a block takes most of an SM's shared memory; query blocks x
    splits <= 132 where the index has that many tiles), none of them
    empty."""
    q_blocks = -(-n_q // _QB)
    v_tiles = -(-n_v // _VB)
    n_split = max(1, min(v_tiles, H100_SMS // q_blocks))
    tiles_per_split = -(-v_tiles // n_split)
    n_split = -(-v_tiles // tiles_per_split)
    return n_split, tiles_per_split * _VB


def knn_topk(queries: torch.Tensor, vectors: torch.Tensor,
             k: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: exact squared-L2 k-NN. For a CUDA tensor it launches the kernel
    (f32 [T, D] queries, f32 [N, D] index, D a multiple of 4, k <= 8) or
    raises; for a CPU
    tensor it runs ``knn_search_plain`` (``knn_search_tiled`` above
    ``TILED_SEARCH_THRESHOLD`` rows or a 2^27-element distance matrix).
    Indices are int64."""
    if queries.device.type == "cpu":
        return _search_plain(queries, vectors, k)
    if queries.device.type != "cuda" or vectors.device != queries.device:
        raise ValueError("knn_topk: queries and vectors must be on one CUDA device")
    for name, t in (("queries", queries), ("vectors", vectors)):
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"knn_topk: {name} must be contiguous 2-D float32")
    n_q, dim = queries.shape
    n_v = vectors.shape[0]
    if vectors.shape[1] != dim:
        raise ValueError("knn_topk: queries and vectors differ in width")
    if dim % 4:
        raise ValueError("knn_topk: the width must be a multiple of 4 "
                         "(16-byte copies)")
    if not 1 <= k <= MAX_K or n_v < k or n_q < 1:
        raise ValueError(f"knn_topk: need 1 <= k <= {MAX_K} and N >= k")
    n_split, split_rows = split_plan(n_q, n_v)
    dev = queries.device
    out_d = torch.empty((n_q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_q, k), dtype=torch.int64, device=dev)
    part_d = torch.empty((n_split, n_q, MAX_K), dtype=torch.float32, device=dev)
    part_i = torch.empty((n_split, n_q, MAX_K), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):  # the launches act on the current device
        err = _lib().rvc_knn_topk(
            queries.data_ptr(), vectors.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), part_d.data_ptr(), part_i.data_ptr(), n_q, n_v,
            dim, k, n_split, split_rows, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"knn_topk: CUDA error {err} at launch")
    launches["knn_topk"] += 1
    return out_d, out_i


def retrieve_blend(feats: torch.Tensor, vectors: torch.Tensor,
                   index_rate: Union[float, torch.Tensor],
                   k: int = 8) -> torch.Tensor:
    """Blend each query frame with its k nearest index vectors:
    w_j = (1/d_j^2) normalized, retrieved = sum_j w_j v_{ix_j},
    out = index_rate * retrieved + (1 - index_rate) * feats."""
    d2, idx = knn_topk(feats, vectors, k)
    w = 1.0 / torch.square(torch.clamp(d2, min=1e-12))
    w = w / torch.sum(w, dim=1, keepdim=True)
    retrieved = torch.sum(vectors[idx] * w[..., None], dim=1)
    return index_rate * retrieved + (1.0 - index_rate) * feats


class FeatureIndex:
    """An index of [N, D] float32 vectors resident on one device."""

    def __init__(self, vectors, device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        v = np.ascontiguousarray(np.asarray(vectors, dtype=np.float32))
        self.vectors = torch.from_numpy(v).to(self.device)
        self.ntotal = v.shape[0]

    @classmethod
    def load(cls, path: str, device: Union[str, torch.device] = "cuda"):
        """Load a native ``.npz`` index (key ``vectors``) or a reference
        faiss ``.index`` file (IndexFlat or IndexIVFFlat)."""
        with open(path, "rb") as f:
            magic = f.read(4)
        if magic[:2] != b"PK":  # not a zip archive: one of the faiss formats
            from ..utils.faiss_io import read_index_vectors

            return cls(read_index_vectors(path), device=device)
        with np.load(path) as data:
            return cls(data["vectors"], device=device)

    def save(self, path: str) -> None:
        np.savez(path, vectors=self.vectors.cpu().numpy())

    def search(self, queries: torch.Tensor, k: int = 8):
        return knn_topk(queries.to(self.device, torch.float32).contiguous(),
                        self.vectors, k)

    def blend(self, feats: torch.Tensor, index_rate: float, k: int = 8):
        return retrieve_blend(feats, self.vectors, index_rate, k)


def kmeans(data: torch.Tensor, n_clusters: int, n_iters: int = 25,
           seed: int = 0, init: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Lloyd's k-means, full batch: data [N, D] float32 -> centroids
    [K, D], on data's device.

    The initial centroids are the rows ``init`` (indices), by default
    ``np.random.default_rng(seed).choice(N, K, replace=False)``. Each
    iteration assigns every row to its nearest centroid through
    ``knn_topk`` at k = 1 (kernel K3 on the card, all rows in one launch;
    on the CPU in chunks that keep [rows, K] under ``DENSE_ELEMS_LIMIT``),
    then sums the rows of each centroid in a fixed order: the rows sorted
    by centroid (a stable sort) and added up segment by segment, with no
    atomics, so that a run repeats bit for bit. A centroid no row chose
    keeps its place."""
    n, dim = data.shape
    if not 1 <= n_clusters <= n:
        raise ValueError(f"kmeans: need 1 <= n_clusters ({n_clusters}) <= rows ({n})")
    if init is None:
        init = np.random.default_rng(seed).choice(n, n_clusters, replace=False)
    init_idx = torch.as_tensor(np.asarray(init, np.int64), device=data.device)
    centroids = data[init_idx].contiguous()
    rows = n if data.device.type == "cuda" else max(1024, DENSE_ELEMS_LIMIT // n_clusters)
    for _ in range(n_iters):
        assign = torch.cat([knn_topk(data[i:i + rows], centroids, 1)[1][:, 0]
                            for i in range(0, n, rows)])
        order = torch.sort(assign, stable=True).indices
        counts = torch.bincount(assign, minlength=n_clusters)
        sums = torch.segment_reduce(data[order], "sum", lengths=counts, axis=0,
                                    unsafe=True)
        c = counts[:, None].to(data.dtype)
        centroids = torch.where(c > 0, sums / torch.clamp(c, min=1.0),
                                centroids).contiguous()
    return centroids
