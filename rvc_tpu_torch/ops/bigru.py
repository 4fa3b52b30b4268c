"""RMVPE's bidirectional GRU recurrence: kernel G ``bigru``, its plain
version and its planner.

``bigru_plain`` is the step loop of ``FusedBiGRU`` (both directions advanced
by one batched product a step), the counterpart of the ``jax.lax.scan`` in
``rvc_tpu/predictors/rmvpe.py`` ``FusedBiGRU``. ``bigru`` launches the
hand-written kernel in ``csrc/bigru.cu`` for CUDA tensors (one launch for
both directions and every row) and runs ``bigru_plain`` for CPU tensors.
Neither has a backward: RMVPE is not trained, and a gradient request
raises.

``plan`` picks the kernel's geometry for any hidden width and batch: a
thread block cluster per (direction, group of rows), each block owning a
share of the hidden units and keeping their columns of Wh in registers
where they fit, else reading them from memory every step.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from ..utils import profiling

launches = {"bigru": 0}

CLUSTERS = (1, 2, 4, 8, 16)   # blocks of a cluster (16: the non-portable size)
KPT_CHOICES = (16, 32)        # weights per gate a thread keeps in registers
ROW_CHOICES = (1, 4, 8)       # batch rows a cluster carries
PREFERRED_THREADS = 256       # a block's threads, where a plan within it exists
REG_OTHER = 56                # registers a thread needs beside weights and rows (csrc)
SM_REGISTERS = 65536
SMEM_LIMIT = 232448           # shared memory a block may use (227 KB)
MEM_CHUNKS = 8                # 4-wide k chunks a lane takes when Wh is read from memory
MIN_UNITS = 16                # hidden units a block keeps, where a smaller cluster allows it
WAVE_BLOCKS = 128             # clusters of 16 the card runs at once: 8 GPCs of 16 SMs


def reset_launches() -> None:
    launches["bigru"] = 0


def bigru_plain(xi_f: torch.Tensor, xi_b: torch.Tensor, wh: torch.Tensor,
                bn: torch.Tensor) -> torch.Tensor:
    """Both directions of the GRU recurrence, one step at a time: xi_f,
    xi_b [B, T, 3H] (the input projections with the folded biases, the
    backward's in time order), wh [2, H, 3H], bn [2, H] (b_hn) ->
    [B, T, 2H], the forward direction then the backward, un-reversed. The
    carry and every op are in the inputs' dtype."""
    b, t, _ = xi_f.shape
    hh = wh.shape[1]
    xi = torch.stack([xi_f, xi_b.flip(1)])                       # [2, B, T, 3H]
    bn = bn[:, None, :]                                          # [2, 1, H]
    h = torch.zeros((2, b, hh), dtype=xi_f.dtype, device=xi_f.device)
    outs = []
    for step in range(t):
        xs = xi[:, :, step]
        g = torch.bmm(h, wh)
        rz = torch.sigmoid(xs[..., :2 * hh] + g[..., :2 * hh])
        r, z = rz[..., :hh], rz[..., hh:]
        n = torch.tanh(xs[..., 2 * hh:] + r * (g[..., 2 * hh:] + bn))
        h = (1.0 - z) * n + z * h
        outs.append(h)
    o = torch.stack(outs, dim=2)                                 # [2, B, T, H]
    return torch.cat([o[0], o[1].flip(1)], dim=-1)


@dataclass(frozen=True)
class BiGruPlan:
    """G's geometry: ``cluster`` blocks per (direction, group of ``rows``
    batch rows; ``groups`` groups), ``units`` hidden units a block, ``ks``
    lanes a unit, ``kpt`` weights per gate a thread in registers (0: read
    from memory every step, ``passes`` units a thread one after another),
    ``kchunks`` 4-wide k chunks a lane, ``threads`` a block, ``smem`` bytes
    a block (h, f32, double-buffered: 2 x rows x kp; two mbarriers)."""
    hidden: int
    batch: int
    bf16: bool
    cluster: int
    units: int
    ks: int
    kpt: int
    kchunks: int
    rows: int
    groups: int
    threads: int
    passes: int
    kp: int
    smem: int

    @property
    def weights_in_registers(self) -> bool:
        return self.kpt > 0

    @property
    def blocks(self) -> int:
        return self.cluster * 2 * self.groups


def prefetch_depth(rows: int) -> int:
    """Steps of xi a thread keeps in flight (csrc's ``prefetch_depth``)."""
    return 4 if rows == 1 else 2


def max_threads(kpt: int, rows: int) -> int:
    """The most threads a block of the (kpt, rows) kernel may have: its
    registers a thread (the weights, f32 in either dtype; a row's 3 sums,
    prefetched xi and new h; ``REG_OTHER``) times the threads, in the groups
    of 128 ptxas allocates for, fit the SM's (csrc's ``max_threads``, its
    ``__launch_bounds__``)."""
    need = -(-(3 * kpt + (4 + 3 * prefetch_depth(rows)) * rows + REG_OTHER) // 8) * 8
    return min(1024, SM_REGISTERS // need // 128 * 128)


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _rows(batch: int) -> int:
    return next(r for r in ROW_CHOICES if r >= min(batch, ROW_CHOICES[-1]))


def _clusters(hidden: int, cluster: Optional[int]):
    """The cluster sizes to try, ascending, in which every block owns at
    least one hidden unit."""
    cands = (cluster,) if cluster else CLUSTERS
    return [c for c in cands if (c - 1) * -(-hidden // c) < hidden]


def plan(hidden: int, batch: int, dtype: torch.dtype,
         cluster: Optional[int] = None) -> BiGruPlan:
    """G's geometry for hidden width ``hidden`` and ``batch`` rows. Wh in
    registers where it fits, first within ``PREFERRED_THREADS`` threads a
    block, then within the registers' bound (for each cluster size, the
    ``kpt`` that pads h the least); of those the largest cluster whose
    blocks keep ``MIN_UNITS`` units and whose blocks all run at once
    (``WAVE_BLOCKS``), else the smallest (measured: at H = 256 clusters of
    16 beat 8 at every batch, and at H = 16 a lone block beats every
    cluster); else Wh read from memory every step at the largest cluster.
    ``cluster`` forces the cluster size (for measurement). Raises only where one row's h, double-buffered in f32,
    cannot fit a block's shared memory (H > 29 056)."""
    if hidden < 1 or batch < 1:
        raise ValueError(f"bigru plan: hidden {hidden} and batch {batch} must be >= 1")
    if cluster is not None and cluster not in CLUSTERS:
        raise ValueError(f"bigru plan: cluster {cluster} not in {CLUSTERS}")
    bf16 = dtype == torch.bfloat16
    hp = -(-hidden // 4) * 4
    clusters = _clusters(hidden, cluster)
    if not clusters:
        raise ValueError(f"bigru plan: a cluster of {cluster} leaves a block no unit "
                         f"at hidden {hidden}")
    rows = _rows(batch)

    def make(cs, units, ks, k, kchunks, rows, threads, passes):
        kp = 4 * ks * kchunks
        return BiGruPlan(hidden, batch, bf16, cs, units, ks, k, kchunks, rows,
                         -(-batch // rows), threads, passes, kp, 2 * rows * kp * 4 + 16)

    for cap in (PREFERRED_THREADS, None):
        plans = []  # a cluster size's best kpt, ascending
        for cs in clusters:
            units = -(-hidden // cs)
            fits = []
            for k in KPT_CHOICES:
                ks = _pow2_at_least(-(-hp // k))
                threads = -(-units * ks // 32) * 32
                limit = max_threads(k, rows)
                if ks > 32 or threads > (min(limit, cap) if cap else limit):
                    continue
                p = make(cs, units, ks, k, k // 4, rows, threads, 1)
                if p.smem <= SMEM_LIMIT:
                    fits.append((ks * k, -k, p))
            if fits:
                plans.append(min(fits, key=lambda f: f[:2])[2])
        if plans:
            wide = [p for p in plans if p.units >= MIN_UNITS and p.blocks <= WAVE_BLOCKS]
            return wide[-1] if wide else plans[0]
    cs = clusters[-1]
    units = -(-hidden // cs)
    chunks = hp // 4
    ks = min(32, _pow2_at_least(-(-chunks // MEM_CHUNKS)))
    kchunks = -(-chunks // ks)
    for rows in [r for r in ROW_CHOICES if r <= rows][::-1]:
        limit = max_threads(0, rows)
        threads = -(-max(1, min(units, limit // ks)) * ks // 32) * 32
        p = make(cs, units, ks, 0, kchunks, rows, threads, -(-units // (threads // ks)))
        if p.smem <= SMEM_LIMIT:
            return p
    raise ValueError(f"bigru plan: hidden {hidden}: one row's state (2 x {4 * p.kp} "
                     f"bytes) exceeds a block's {SMEM_LIMIT} bytes of shared memory")


def _lib():
    from ._build import load

    lib = load("bigru")
    if not getattr(lib, "_rvc_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rvc_bigru.argtypes = [p, p, p, p, p] + [i] * 12 + [p]
        lib.rvc_bigru.restype = i
        lib._rvc_typed = True
    return lib


def _check(xi_f, xi_b, wh, bn):
    b, t, h3 = xi_f.shape
    hh = wh.shape[1] if wh.dim() == 3 else -1
    if (xi_b.shape != xi_f.shape or wh.shape != (2, hh, 3 * hh) or h3 != 3 * hh
            or bn.shape != (2, hh)):
        raise ValueError(f"bigru: shapes xi {tuple(xi_f.shape)} / {tuple(xi_b.shape)}, "
                         f"wh {tuple(wh.shape)}, bn {tuple(bn.shape)} do not match "
                         "[B, T, 3H], [2, H, 3H], [2, H]")
    return b, t, hh


@profiling.annotated("rvc.bigru")
def bigru(xi_f: torch.Tensor, xi_b: torch.Tensor, wh: torch.Tensor, bn: torch.Tensor,
          plan_: Optional[BiGruPlan] = None, exchange_only: bool = False) -> torch.Tensor:
    """G: ``bigru_plain``'s function in one launch for CUDA tensors (f32 or
    bf16, one dtype, contiguous; the carry rounded to that dtype after every
    step, the product and the gates in f32), or raises; ``bigru_plain`` for
    CPU tensors. ``plan_`` overrides ``plan``'s geometry, and
    ``exchange_only`` runs the loads and the exchange alone (the latency
    floor; not G's function): both for measurement."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (xi_f, xi_b, wh, bn)):
        raise RuntimeError("bigru has no backward (RMVPE is not trained): call it "
                           "under torch.no_grad()")
    b, t, hh = _check(xi_f, xi_b, wh, bn)
    if xi_f.device.type == "cpu":
        return bigru_plain(xi_f, xi_b, wh, bn)
    dev = xi_f.device
    if dev.type != "cuda" or any(x.device != dev for x in (xi_b, wh, bn)):
        raise ValueError("bigru: every tensor must be on one CUDA device")
    if xi_f.dtype not in (torch.float32, torch.bfloat16) or any(
            x.dtype != xi_f.dtype for x in (xi_b, wh, bn)):
        raise ValueError("bigru: one dtype, float32 or bfloat16, for every tensor")
    if not all(x.is_contiguous() for x in (xi_f, xi_b, wh, bn)):
        raise ValueError("bigru: every tensor must be contiguous")
    out = torch.empty((b, t, 2 * hh), dtype=xi_f.dtype, device=dev)
    if t == 0:
        return out
    p = plan_ or plan(hh, b, xi_f.dtype)
    with torch.cuda.device(dev):  # the launch acts on the current device
        err = _lib().rvc_bigru(
            xi_f.data_ptr(), xi_b.data_ptr(), wh.data_ptr(), bn.data_ptr(), out.data_ptr(),
            int(xi_f.dtype == torch.bfloat16), b, t, hh, p.cluster, p.units, p.ks, p.kpt,
            p.kchunks, p.rows, p.threads, int(exchange_only),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bigru: CUDA error {err} at launch ({p})")
    launches["bigru"] += 1
    return out
