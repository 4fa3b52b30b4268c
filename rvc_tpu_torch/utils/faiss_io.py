"""Reader and writer of faiss index files (port of
``rvc_tpu/utils/faiss_io.py``).

The reference ships its retrieval index as a faiss binary (``IVF{n},Flat``,
or a flat index) and uses only the full vector matrix in id order
(``faiss.read_index`` + ``reconstruct_n(0, ntotal)``). This module reads
that matrix from the on-disk serialization directly, and writes a matrix
back as an ``IndexFlat`` or an ``IndexIVFFlat`` (coarse quantizer from a
small numpy k-means) that faiss reads (faiss >= 1.6.1):

  index file      := fourcc payload
  IndexFlat       := "IxF2"|"IxFI"|"IxFl" header xb_floats
  IndexIVFFlat    := "IwFl" header nlist:u64 nprobe:u64 <quantizer index>
                     direct_map inverted_lists
  header          := d:i32 ntotal:i64 dummy:i64 dummy:i64 is_trained:u8
                     metric_type:i32 [metric_arg:f32 if metric_type > 1]
  xb_floats       := count:u64 f32[count]
  direct_map      := type:u8 vec<i64> [vec<pair<i64,i64>> if type == 2]
  inverted_lists  := "ilar" nlist:u64 code_size:u64 ("full" vec<u64 sizes>
                     | "sprs" vec<u64 (list_no, size) pairs>)
                     then per non-empty list: codes[n*code_size] ids:i64[n]
  vec<T>          := count:u64 T[count]

All integers little-endian. IVF vectors are scattered back to rows by their
stored ids; a truncated file or an unknown fourcc raises ``ValueError``.
"""

from __future__ import annotations

import io
import os
import struct
from typing import BinaryIO, Optional, Tuple

import numpy as np

FOURCC_IVF_FLAT = b"IwFl"
FOURCC_FLAT_GENERIC = b"IxFl"
FOURCC_FLAT_IP = b"IxFI"
FOURCC_FLAT_L2 = b"IxF2"
_FLAT_FOURCCS = (FOURCC_FLAT_L2, FOURCC_FLAT_IP, FOURCC_FLAT_GENERIC)

METRIC_INNER_PRODUCT = 0
METRIC_L2 = 1


def is_faiss_file(path: str) -> bool:
    """Whether the file starts with the fourcc of a faiss index this module
    reads."""
    try:
        with open(path, "rb") as f:
            magic = f.read(4)
    except OSError:
        return False
    return magic in _FLAT_FOURCCS or magic == FOURCC_IVF_FLAT


def _read(f: BinaryIO, n: int) -> bytes:
    buf = f.read(n)
    if len(buf) != n:
        raise ValueError(
            f"truncated faiss file: wanted {n} bytes, got {len(buf)}")
    return buf


def _read_u64(f: BinaryIO) -> int:
    return struct.unpack("<Q", _read(f, 8))[0]


def _read_header(f: BinaryIO) -> Tuple[int, int, bool, int]:
    """(d, ntotal, is_trained, metric_type); consumes metric_arg if any."""
    d = struct.unpack("<i", _read(f, 4))[0]
    ntotal = struct.unpack("<q", _read(f, 8))[0]
    _read(f, 16)  # two legacy dummy i64 fields (written as 1 << 20)
    is_trained = bool(_read(f, 1)[0])
    metric_type = struct.unpack("<i", _read(f, 4))[0]
    if metric_type > 1:
        _read(f, 4)  # metric_arg: f32, unused for L2/IP
    if d <= 0 or ntotal < 0:
        raise ValueError(f"implausible faiss header: d={d} ntotal={ntotal}")
    return d, ntotal, is_trained, metric_type


def _read_flat_body(f: BinaryIO) -> np.ndarray:
    """IndexFlat payload after its fourcc: header + float codes."""
    d, ntotal, _, _ = _read_header(f)
    count = _read_u64(f)
    if count != d * ntotal:
        raise ValueError(
            f"IndexFlat size mismatch: {count} floats for d={d} n={ntotal}")
    data = np.frombuffer(_read(f, 4 * count), dtype="<f4")
    return data.reshape(ntotal, d).astype(np.float32, copy=True)


def _skip_direct_map(f: BinaryIO) -> None:
    dm_type = _read(f, 1)[0]
    n = _read_u64(f)
    _read(f, 8 * n)  # array entries (i64)
    if dm_type == 2:  # Hashtable: vector of (key, value) i64 pairs
        n = _read_u64(f)
        _read(f, 16 * n)


def _read_ivf_flat_body(f: BinaryIO) -> np.ndarray:
    d, ntotal, _, _ = _read_header(f)
    nlist = _read_u64(f)
    _read_u64(f)  # nprobe (runtime knob, irrelevant to the payload)

    sub = _read(f, 4)  # nested coarse-quantizer index
    if sub in _FLAT_FOURCCS:
        _read_flat_body(f)  # centroids: not needed to reconstruct vectors
    else:
        raise ValueError(
            f"unsupported IVF coarse quantizer fourcc {sub!r} (only flat "
            "quantizers, i.e. factory 'IVFn,Flat', are supported)")
    _skip_direct_map(f)

    if _read(f, 4) != b"ilar":
        raise ValueError("unsupported InvertedLists layout (expected 'ilar')")
    il_nlist = _read_u64(f)
    code_size = _read_u64(f)
    if il_nlist != nlist:
        raise ValueError(f"invlists nlist {il_nlist} != header nlist {nlist}")
    if code_size != 4 * d:
        raise ValueError(
            f"code_size {code_size} != 4*d={4 * d}: not an IVF*Flat* index")

    list_type = _read(f, 4)
    sizes = np.zeros(nlist, dtype=np.int64)
    if list_type == b"full":
        count = _read_u64(f)
        if count != nlist:
            raise ValueError(f"sizes vector length {count} != nlist {nlist}")
        sizes[:] = np.frombuffer(_read(f, 8 * count), dtype="<u8")
    elif list_type == b"sprs":
        count = _read_u64(f)
        pairs = np.frombuffer(_read(f, 8 * count), dtype="<u8")
        sizes[pairs[0::2].astype(np.int64)] = pairs[1::2].astype(np.int64)
    else:
        raise ValueError(f"unknown inverted-list encoding {list_type!r}")
    if int(sizes.sum()) != ntotal:
        raise ValueError(
            f"inverted lists hold {int(sizes.sum())} ids, header says "
            f"{ntotal}")

    out = np.zeros((ntotal, d), dtype=np.float32)
    seen = np.zeros(ntotal, dtype=bool)
    for n in sizes:
        n = int(n)
        if n == 0:
            continue
        codes = np.frombuffer(_read(f, n * code_size), dtype="<f4")
        ids = np.frombuffer(_read(f, 8 * n), dtype="<i8")
        if ids.min() < 0 or ids.max() >= ntotal:
            raise ValueError("inverted-list id outside [0, ntotal)")
        out[ids] = codes.reshape(n, d)
        seen[ids] = True
    if not seen.all():
        raise ValueError("duplicate ids in inverted lists left rows unset")
    return out


def read_index_vectors(path: str) -> np.ndarray:
    """Full [ntotal, d] float32 matrix in id order — what the reference gets
    from ``faiss.read_index(path)`` + ``reconstruct_n(0, ntotal)``."""
    with open(path, "rb") as f:
        magic = _read(f, 4)
        if magic == FOURCC_IVF_FLAT:
            return _read_ivf_flat_body(f)
        if magic in _FLAT_FOURCCS:
            return _read_flat_body(f)
    raise ValueError(
        f"unsupported faiss index type {magic!r} in {path}: only IndexFlat "
        "and IndexIVFFlat (the formats RVC/Applio produce) are supported")


def _write_u64(f: BinaryIO, v: int) -> None:
    f.write(struct.pack("<Q", v))


def _write_header(f: BinaryIO, d: int, ntotal: int, metric_type: int) -> None:
    f.write(struct.pack("<i", d))
    f.write(struct.pack("<q", ntotal))
    f.write(struct.pack("<q", 1 << 20))  # legacy dummy fields, as faiss does
    f.write(struct.pack("<q", 1 << 20))
    f.write(b"\x01")  # is_trained
    f.write(struct.pack("<i", metric_type))


def _write_flat(f: BinaryIO, vectors: np.ndarray, metric_type: int) -> None:
    fourcc = FOURCC_FLAT_L2 if metric_type == METRIC_L2 else FOURCC_FLAT_IP
    f.write(fourcc)
    _write_header(f, vectors.shape[1], vectors.shape[0], metric_type)
    _write_u64(f, vectors.size)
    f.write(np.ascontiguousarray(vectors, dtype="<f4").tobytes())


def write_index_flat(path: str, vectors: np.ndarray,
                     metric_type: int = METRIC_L2) -> None:
    """Write an IndexFlat file readable by ``faiss.read_index``."""
    vectors = np.asarray(vectors, dtype=np.float32)
    with open(path, "wb") as f:
        _write_flat(f, vectors, metric_type)


def default_nlist(n: int) -> int:
    """The reference's IVF size rule: 16 sqrt(n), at most n / 39."""
    return max(1, min(int(16 * np.sqrt(n)), n // 39 if n >= 39 else 1))


def _kmeans_np(vectors: np.ndarray, k: int, iters: int = 10,
               seed: int = 0) -> np.ndarray:
    """Small numpy Lloyd for the coarse quantizer (its quality only
    affects faiss's recall at a given nprobe, not the stored vectors)."""
    rng = np.random.default_rng(seed)
    n = vectors.shape[0]
    cents = vectors[rng.choice(n, size=min(k, n), replace=False)].copy()
    if cents.shape[0] < k:  # degenerate tiny input: pad with repeats
        cents = np.concatenate(
            [cents, cents[rng.integers(0, cents.shape[0], k - cents.shape[0])]])
    for _ in range(iters):
        assign = _assign_chunked(vectors, cents)
        for c in range(k):
            m = assign == c
            if m.any():
                cents[c] = vectors[m].mean(axis=0)
    return cents


def _assign_chunked(vectors: np.ndarray, cents: np.ndarray,
                    chunk: int = 16384) -> np.ndarray:
    c2 = (cents * cents).sum(axis=1)
    out = np.empty(vectors.shape[0], dtype=np.int64)
    for i in range(0, vectors.shape[0], chunk):
        v = vectors[i:i + chunk]
        d2 = c2[None, :] - 2.0 * (v @ cents.T)  # + |v|^2, constant per row
        out[i:i + chunk] = np.argmin(d2, axis=1)
    return out


def write_index_ivf_flat(
    path: str,
    vectors: np.ndarray,
    nlist: Optional[int] = None,
    nprobe: int = 1,
    centroids: Optional[np.ndarray] = None,
    seed: int = 0,
) -> int:
    """Write an IndexIVFFlat file byte-compatible with ``faiss.write_index``.

    Returns the nlist used (needed for the reference's
    ``..._IVF{n}_Flat_...`` file-naming convention). Pass ``centroids`` to
    reuse an existing coarse quantizer.
    """
    vectors = np.ascontiguousarray(vectors, dtype=np.float32)
    n, d = vectors.shape
    if nlist is None:
        nlist = default_nlist(n)
    if centroids is None:
        centroids = _kmeans_np(vectors, nlist, seed=seed)
    centroids = np.asarray(centroids, dtype=np.float32)
    if centroids.shape != (nlist, d):
        raise ValueError(f"centroids {centroids.shape} != ({nlist}, {d})")
    assign = _assign_chunked(vectors, centroids)

    lists_ids = [np.nonzero(assign == c)[0].astype("<i8")
                 for c in range(nlist)]
    buf = io.BytesIO()
    buf.write(FOURCC_IVF_FLAT)
    _write_header(buf, d, n, METRIC_L2)
    _write_u64(buf, nlist)
    _write_u64(buf, nprobe)
    _write_flat(buf, centroids, METRIC_L2)   # coarse quantizer
    buf.write(b"\x00")                        # DirectMap: NoMap
    _write_u64(buf, 0)                        # empty direct-map array
    buf.write(b"ilar")
    _write_u64(buf, nlist)
    _write_u64(buf, 4 * d)                    # code_size
    n_non0 = sum(1 for ids in lists_ids if ids.size)
    if n_non0 > nlist // 2:                   # faiss's density rule
        buf.write(b"full")
        _write_u64(buf, nlist)
        buf.write(np.array([ids.size for ids in lists_ids],
                           dtype="<u8").tobytes())
    else:
        buf.write(b"sprs")
        pairs = []
        for c, ids in enumerate(lists_ids):
            if ids.size:
                pairs.extend((c, ids.size))
        _write_u64(buf, len(pairs))
        buf.write(np.array(pairs, dtype="<u8").tobytes())
    for ids in lists_ids:
        if ids.size:
            buf.write(vectors[ids].astype("<f4").tobytes())
            buf.write(ids.tobytes())

    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)
    return nlist
