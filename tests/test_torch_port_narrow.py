"""The narrow chain kernel's host side on the CPU (``ops/resblock.py``:
``narrow_plan``, ``pack_conv_narrow`` / ``pack_narrow``, the routes' rule)
and its tiling emulated in plain torch against the plain versions; and the
JAX package's Pallas kernels (interpret mode) in the kernel's regime, C = 32
and 64 at RefineGAN's slope 0.2, against the port's plain versions.

Tolerances: f32 1e-5 of the output's largest magnitude (the summation order
differs); bf16 I/O 1e-2 (both sides compute in f32 from the same bf16 input
and round the result to bf16 once: at most one bf16 step, 2^-8 of a value,
apart). The tiling emulation holds 1e-6 (the same convs, cut into tiles).
The CUDA kernel itself is held against the plain versions on the card by
``chip_smoke.py``.
"""

import _torch_threads  # noqa: F401  one CPU thread a process (see the module)

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rvc_tpu_torch.ops import resblock as rb

DIL = (1, 3, 5)
CHAIN_SETS = [((3,), DIL), ((7,), DIL), ((11,), DIL), ((3, 7, 11), DIL), ((3, 7), (1, 3))]


def _rel(ref, out):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    assert ref.shape == out.shape
    return float(np.abs(ref - out).max() / max(np.abs(ref).max(), 1e-9))


def _chain_np(rng, c, k, dil):
    """One chain's weights: JAX layout [K, C_in, C_out] and biases."""
    w = lambda: (rng.normal(size=(k, c, c)) * (0.5 / np.sqrt(c * k))).astype(np.float32)
    b = lambda: (rng.normal(size=(c,)) * 0.05).astype(np.float32)
    return [w() for _ in dil], [b() for _ in dil], [w() for _ in dil], [b() for _ in dil]


def _to_torch_chain(ch):
    k1, b1, k2, b2 = ch
    conv = lambda ws: [torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0)))
                       for w in ws]
    return conv(k1), [torch.from_numpy(b) for b in b1], conv(k2), \
        [torch.from_numpy(b) for b in b2]


# configs the planner refused while a tap could reach only 32 guard rows
# and a block recomputed its own halo (ROADMAP C1): they fit now
WIDER_SETS = [((11,), (1, 7)), ((11,), (6, 6, 6, 6)), ((3, 7, 15), DIL),
              ((3, 7, 11), (1, 3, 9)), ((3, 7, 11), (1, 3, 5, 7))]


@pytest.mark.parametrize("ks,dil", CHAIN_SETS + WIDER_SETS)
@pytest.mark.parametrize("c", [16, 32, 48, 64])
def test_narrow_plan_fits_the_block(c, ks, dil):
    """A block's buffer is 16384 / cp rows (two warpgroups of 128 / cp
    bands of 64 rows); the 1 or 2 blocks of a cluster share one buffer and
    store the rows no conv spoils; no tap reaches past the 128 guard rows,
    and ``reach``, the rows a block sends its neighbour, is the furthest
    any tap reaches. One f32 plane, a ring of at least two 16 KB weight
    stages and the barriers fit the 232,448 bytes a block may use. The
    state and conv_d's sums take 128 registers a consumer thread, which
    leaves at least 64 of its 240 for the A fragments, and the warpgroups'
    registers fit the SM's."""
    p = rb.narrow_plan(c, ks, dil)
    assert p.cp == rb.narrow_channels(c) and p.cp in rb.NARROW_CHANNELS and p.cp >= c
    assert p.rows * p.cp == rb.NARROW_BLOCK_ELEMS and p.rows % 128 == 0
    assert p.cluster in rb.NARROW_CLUSTERS
    assert p.halo == max(k // 2 * sum(d + 1 for d in dil) for k in ks)
    assert p.tile == p.cluster * p.rows - 2 * p.halo and p.tile >= 1
    assert p.reach == max(k // 2 * d for k in ks for d in (*dil, 1))
    assert p.reach <= rb.NARROW_GUARD == 128 <= p.rows
    assert 2 <= p.stages <= rb.NARROW_MAX_STAGES
    assert p.smem == ((p.rows + 2 * rb.NARROW_GUARD) * p.cp * 4
                      + p.stages * rb.NARROW_STAGE_BYTES + rb.NARROW_BARRIERS * 8)
    assert p.smem <= rb.SMEM_LIMIT
    # one more stage would not fit, or the ring is at its depth
    assert p.stages == rb.NARROW_MAX_STAGES or p.smem + rb.NARROW_STAGE_BYTES > rb.SMEM_LIMIT
    # y and m: 2 arrays of (128 / cp) bands x cp / 2 registers
    assert 2 * (128 // p.cp) * (p.cp // 2) == p.regs == rb.NARROW_ACC_REGS
    assert p.regs + 64 <= rb.NARROW_CONSUMER_REGS
    assert (rb.NARROW_CONSUMERS * rb.NARROW_CONSUMER_REGS
            + rb.NARROW_PRODUCERS * rb.NARROW_PRODUCER_REGS) <= rb.SM_REGISTERS
    # a 16 KB ring stage holds whole (tap, 8-channel depth step) units
    assert rb.NARROW_STAGE_BYTES % (64 * p.cp) == 0


@pytest.mark.parametrize("c,t,b,ks,dil,cluster", [
    (32, 511360, 1, (3,), DIL, 1),           # a short halo: lone blocks, fewer waves
    (32, 511360, 1, (11,), DIL, 2),          # 10 waves of lone blocks, 9 of pairs
    (32, 767040, 1, (3, 7, 11), DIL, 2),
    (64, 255680, 1, (11,), DIL, 2),          # a lone block would store 136 of 256 rows
    (64, 5760, 8, (3,), DIL, 1),             # two waves either way
    (64, 1, 1, (11,), (6, 6, 6, 6), 2),      # the halo leaves a lone block no rows
])
def test_narrow_plan_picks_the_cluster_with_fewer_waves(c, t, b, ks, dil, cluster):
    """The cluster size whose waves of blocks over the card's 132 SMs,
    each block of a pair weighed by 1 + NARROW_EXCHANGE_COST, cost least;
    a forced size is kept where it fits and refused where it does not."""
    p = rb.narrow_plan(c, ks, dil, t, b)
    assert p.cluster == cluster

    def cost(n):
        tile = n * p.rows - 2 * p.halo
        if tile < 1:
            return float("inf")
        blocks = n * b * -(-t // tile)
        return -(-blocks // 132) * (1 + rb.NARROW_EXCHANGE_COST * (n - 1))
    assert cost(cluster) <= cost(3 - cluster)
    for n in (1, 2):
        if n * p.rows - 2 * p.halo >= 1:
            assert rb.narrow_plan(c, ks, dil, t, b, cluster=n).cluster == n
        else:
            with pytest.raises(ValueError):
                rb.narrow_plan(c, ks, dil, t, b, cluster=n)


@pytest.mark.parametrize("c,ks,dil", [
    (128, (3, 7, 11), DIL),          # over 64 channels: the wide kernel's
    (256, (3,), DIL),
    (32, (3,), (1, 129)),            # a tap reaches 129 rows, over the 128 guard rows
    (16, (11,), (30, 30, 30, 30)),   # 150 rows
    (64, (21,), (9, 9, 9, 9)),       # the chain spoils more rows than a cluster has
    (32, (3,), (1, 1, 1, 1, 1)),     # more dilations than the kernel takes
    (32, (3, 3, 3, 3, 3), (1,)),     # more chains than the kernel takes
    (16, (4,), (1,)),                # an even kernel size
])
def test_narrow_plan_refuses_what_does_not_fit(c, ks, dil):
    with pytest.raises(ValueError):
        rb.narrow_plan(c, ks, dil)


@pytest.mark.parametrize("c,cp", [(1, 16), (16, 16), (17, 32), (32, 32), (33, 64),
                                  (48, 64), (64, 64)])
def test_narrow_channels_pad_to_the_built_widths(c, cp):
    assert rb.narrow_channels(c) == cp


def test_dispatch_rule():
    """The measured rule: the narrow kernel takes every chain and every f32
    stage tail at C <= 64 in either dtype; wider ones take K2 (a bf16 stage
    tail at C <= 128 takes K1, before the rule is asked)."""
    for c in (1, 8, 16, 24, 32, 48, 64):
        for dtype in (torch.float32, torch.bfloat16):
            assert rb.chain_route(c, dtype, 3, (1,)) == "narrow"
        assert rb.stage_route(c, torch.float32, (3,), (1,)) == "narrow"
        assert rb.stage_route(c, torch.bfloat16, (3,), (1,)) == "k1"
    for c in (65, 96, 128, 256, 512):
        for dtype in (torch.float32, torch.bfloat16):
            assert rb.chain_route(c, dtype, 3, (1,)) == "wide"
            assert rb.stage_route(c, dtype, (3,), (1,)) != "narrow"


@pytest.mark.parametrize("c", [16, 32, 64])
def test_pack_conv_narrow_follows_unit_layout(c):
    """A conv's packed weights are the B operands of the kernel's products,
    unit after unit: f32 element ((((tap * C/8 + ci // 8) * 2 + plane) * 2
    + ci % 8 // 4) * C + co) * 4 + ci % 4 is plane `plane` (big, small) of
    W[co, ci, tap]; the two planes add up to the weights."""
    k = 5
    w = torch.randn((c, c, k), generator=torch.Generator().manual_seed(c)) * 0.1
    packed = rb.pack_conv_narrow(w)
    assert packed.dtype == torch.float32 and packed.numel() == 2 * k * c * c
    big, small = rb.split_tf32(w)
    rng = np.random.default_rng(c)
    for _ in range(300):
        tap, ci, co, plane = rng.integers(k), rng.integers(c), rng.integers(c), rng.integers(2)
        flat = ((((tap * (c // 8) + ci // 8) * 2 + plane) * 2 + ci % 8 // 4) * c + co) * 4 + ci % 4
        assert float(packed[flat]) == float((big, small)[plane][co, ci, tap])
    units = packed.reshape(k, c // 8, 2, 2, c, 4)
    whole = (units[:, :, 0] + units[:, :, 1]).permute(3, 1, 2, 4, 0).reshape(c, c, k)
    assert torch.equal(whole, w)
    assert not (units[:, :, 0].contiguous().view(torch.int32) & 0x1FFF).any()


def test_pack_narrow_orders_convs_and_pads():
    """The launch's stream is chain after chain, conv_d then conv_1 per
    dilation, each conv 8 * K * cp^2 bytes; a 48-channel stage packs at 64
    with zero weights and biases in the extra channels."""
    c, cp, ks, dil = 48, 64, (3, 7), (1, 3)
    rng = np.random.default_rng(12)
    chains = [_to_torch_chain(_chain_np(rng, c, k, dil)) for k in ks]
    packed = rb.pack_narrow(chains, cp)
    assert packed.w.numel() == sum(2 * len(dil) * 2 * k * cp * cp for k in ks)
    assert packed.bias.shape == (2 * len(dil) * len(ks), cp)
    off = 0
    for ci, ((w1s, b1s, w2s, b2s), k) in enumerate(zip(chains, ks)):
        for di in range(len(dil)):
            for j, (w, b) in enumerate(((w1s[di], b1s[di]), (w2s[di], b2s[di]))):
                units = packed.w[off:off + 2 * k * cp * cp].reshape(k, cp // 8, 2, 2, cp, 4)
                back = (units[:, :, 0] + units[:, :, 1]).permute(3, 1, 2, 4, 0)
                back = back.reshape(cp, cp, k)
                assert torch.equal(back[:c, :c], w)
                assert not back[c:].any() and not back[:, c:].any()
                row = packed.bias[(ci * len(dil) + di) * 2 + j]
                assert torch.equal(row[:c], b) and not row[c:].any()
                off += 2 * k * cp * cp


def _narrow_tiled(x, chains, ks, dil, slope, cluster=None):
    """The narrow kernel's tiling in plain torch, f32: x and the weights
    padded to the plan's channels; per (batch row, tile) a cluster of
    ``plan.cluster`` blocks, each with a plane of ``rows`` rows between
    zero guard rows, the cluster's buffer starting ``halo`` rows before the
    tile. Every conv computes all of a block's rows from its plane (taps
    past its rows read the guard rows), the mask zeroes the rows outside
    [0, T) after every conv, each conv's output overwrites the plane, and
    after every plane write each block's ``reach`` edge rows land in its
    neighbour's guard rows (the rest of the guard rows stay zero). The
    chains run one after the other; the sum waits in the output, the last
    chain's store scales by 1 / n, and only rows [halo, halo + tile) of the
    cluster's buffer are stored."""
    b, c, t = x.shape
    p = rb.narrow_plan(c, ks, dil, t, b, cluster=cluster)
    cp, rows, g, n_blk = p.cp, p.rows, rb.NARROW_GUARD, p.cluster
    xp = F.pad(x, (0, 0, 0, cp - c))
    padded = []
    for w1s, b1s, w2s, b2s in chains:
        ws, bs = rb._pad_weights([*w1s, *w2s], [*b1s, *b2s], cp)
        n = len(dil)
        padded.append((ws[:n], bs[:n], ws[n:], bs[n:]))
    out = torch.zeros_like(xp)
    leaky = lambda v: torch.where(v >= 0, v, v * slope)

    def conv(plane, w, bias, k, d):
        reach = k // 2 * d
        assert reach <= p.reach <= g
        return F.conv1d(plane[:, :, g - reach:g + rows + reach], w, bias, dilation=d)

    def write(planes, values):
        """Each block's plane = values, then the edge rows to the neighbours."""
        for plane, v in zip(planes, values):
            plane[:, :, g:g + rows] = v
        r = p.reach
        for lo, hi in zip(planes, planes[1:]):
            hi[:, :, g - r:g] = lo[:, :, g + rows - r:g + rows]
            lo[:, :, g + rows:g + rows + r] = hi[:, :, g:g + r]

    for ti in range(-(-t // p.tile)):
        g0 = ti * p.tile - p.halo
        times = [torch.arange(g0 + i * rows, g0 + (i + 1) * rows) for i in range(n_blk)]
        oks = [(tm >= 0) & (tm < t) for tm in times]
        lo, cnt = ti * p.tile, min(p.tile, t - ti * p.tile)
        for ci, ((w1s, b1s, w2s, b2s), k) in enumerate(zip(padded, ks)):
            ys = []
            for tm, ok in zip(times, oks):
                y = torch.zeros((b, cp, rows))
                y[:, :, ok] = xp[:, :, tm[ok]]
                ys.append(y)
            planes = [torch.zeros((b, cp, rows + 2 * g)) for _ in range(n_blk)]
            write(planes, [leaky(y) for y in ys])
            for d, w1, b1, w2, b2 in zip(dil, w1s, b1s, w2s, b2s):
                ms = [conv(pl, w1, b1, k, d) * ok for pl, ok in zip(planes, oks)]
                write(planes, [leaky(m) for m in ms])
                ys = [(y + conv(pl, w2, b2, k, 1)) * ok
                      for y, pl, ok in zip(ys, planes, oks)]
                write(planes, [leaky(y) for y in ys])
            rows_out = torch.cat(ys, dim=2)[:, :, p.halo:p.halo + cnt]
            prev = out[:, :, lo:lo + cnt] if ci > 0 else 0.0
            scale = 1.0 / len(ks) if ci == len(ks) - 1 else 1.0
            out[:, :, lo:lo + cnt] = (rows_out + prev) * scale
    return out[:, :c]


@pytest.mark.parametrize("b,c,t,ks,dil,slope,cluster", [
    (2, 32, 1, (11,), DIL, 0.2, None),          # T = 1
    (1, 64, 391, (11,), DIL, 0.2, 2),           # one cluster's tile - 1
    (1, 64, 393, (11,), DIL, 0.2, 2),           # one tile + 1: a last partial tile
    (1, 64, 137, (11,), DIL, 0.2, 1),           # a lone block's tile + 1
    (2, 48, 300, (7,), DIL, 0.2, None),         # a padded width, batch 2
    (1, 16, 2001, (3,), DIL, 0.1, None),        # the widest buffer, three tiles
    (2, 32, 1000, (3, 7, 11), DIL, 0.1, 2),     # an f32 stage: the sum over chains, 1/n
    (1, 16, 2001, (3, 7), (1, 3), 0.1, 2),      # two chains of two dilations
    (1, 32, 2500, (3, 7, 15), (1, 3, 9), 0.1, 2),  # a tap reaches 63 rows
    (1, 64, 900, (11,), (1, 3, 5, 7), 0.2, 2),  # four dilations, 100 rows of halo
])
def test_narrow_tiling_matches_plain(b, c, t, ks, dil, slope, cluster):
    """Tile by tile and block by block with the plan's rows, halo, guard
    rows, edge-row exchange, masks and the sum over chains in the output,
    one chain is ``resblock_chain_plain`` and several are
    ``mrf_stage_plain`` on the whole signal (f32, 1e-6 of the output's
    magnitude)."""
    assert [rb.narrow_plan(w, (11,), DIL, cluster=2).tile for w in (64, 32, 16)] == \
        [392, 904, 1928]
    assert [rb.narrow_plan(w, (11,), DIL, cluster=1).tile for w in (64, 32, 16)] == \
        [136, 392, 904]
    rng = np.random.default_rng(b * 1000 + c + t)
    x = torch.from_numpy((rng.normal(size=(b, c, t)) * 0.3).astype(np.float32))
    chains = [_to_torch_chain(_chain_np(rng, c, k, dil)) for k in ks]
    if len(ks) == 1:
        ref = rb.resblock_chain_plain(x, *chains[0], dil, slope)
    else:
        ref = rb.mrf_stage_plain(x, chains, dil, slope)
    out = _narrow_tiled(x, chains, ks, dil, slope, cluster)
    assert _rel(ref.numpy(), out.numpy()) <= 1e-6


def _ntc(x):
    return np.ascontiguousarray(np.asarray(x, np.float32).transpose(0, 2, 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,k", [(32, 11), (64, 7)])
def test_pallas_resblock_interpret_matches_plain_at_narrow_widths(c, k, dtype):
    """JAX's ``fused_resblock`` (interpret mode) at RefineGAN's slope 0.2
    and the narrow kernel's widths, with f32 and bf16 I/O, against the
    port's ``resblock_chain`` on the CPU (its plain version; the launch
    counts stay 0): f32 within 1e-5, bf16 within 1e-2 of the largest
    value."""
    from rvc_tpu.ops.resblock_pallas import fused_resblock

    rng = np.random.default_rng(c + k)
    t = 1024
    x = (rng.normal(size=(1, t, c)) * 0.3).astype(np.float32)
    ch = _chain_np(rng, c, k, DIL)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = fused_resblock(jnp.asarray(x).astype(jdt), *[[jnp.asarray(a) for a in p] for p in ch],
                         DIL, slope=0.2, tile=128, interpret=True)
    assert ref.dtype == jdt
    xt = torch.from_numpy(_ntc(x)).to(getattr(torch, dtype))
    rb.reset_launches()
    out = rb.resblock_chain(xt, *_to_torch_chain(ch), DIL, slope=0.2)
    assert out.dtype == xt.dtype and rb.launches["narrow_chain"] == 0
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert _rel(_ntc(ref.astype(jnp.float32)), out.float().numpy()) <= tol


@pytest.mark.parametrize("c", [32, 64])
def test_pallas_mrf_interpret_matches_plain_in_f32(c):
    """JAX's ``fused_mrf`` (interpret mode) in f32 (f32 dot operands, as it
    computes an f32 stage) against the port's ``mrf_stage`` on the CPU (its
    plain version; the launch counts stay 0), within 1e-5."""
    from rvc_tpu.ops.resblock_pallas import fused_mrf

    rng = np.random.default_rng(c)
    t, ks = 1024, (3, 7, 11)
    x = (rng.normal(size=(1, t, c)) * 0.3).astype(np.float32)
    chains = [_chain_np(rng, c, k, DIL) for k in ks]
    jchains = [[[jnp.asarray(a) for a in p] for p in ch] for ch in chains]
    ref = fused_mrf(jnp.asarray(x), jchains, ks, DIL, tile=128, interpret=True)
    rb.reset_launches()
    out = rb.mrf_stage(torch.from_numpy(_ntc(x)), [_to_torch_chain(ch) for ch in chains],
                       ks, DIL, slope=0.1)
    assert rb.launches["narrow_chain"] == 0 and rb.launches["resblock_chain"] == 0
    assert _rel(_ntc(ref), out.numpy()) <= 1e-5
