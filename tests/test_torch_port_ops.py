"""The port's kernel modules on the CPU: each plain version against the JAX
package's function on the same numpy inputs, and the JAX package's Pallas
kernels (interpret mode) at a small size against the same plain versions.

Tolerance: f32 max abs error <= 1e-5 relative to the output's max magnitude
(only the summation order differs). CPU tensors take the plain path, so the
launch counters must stay 0. The CUDA kernels themselves are held against
these plain versions on the card by ``chip_smoke.py``.
"""

import _torch_threads  # noqa: F401  one CPU thread a process (see the module)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rvc_tpu_torch.ops import resblock as rb
from rvc_tpu_torch.ops import retrieval as rt
from rvc_tpu_torch.utils.weight_cache import WeightCache

REL_TOL = 1e-5
DIL = (1, 3, 5)


def _rel(ref, out):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    assert ref.shape == out.shape
    return float(np.abs(ref - out).max() / max(np.abs(ref).max(), 1e-9))


def _chain_np(rng, c, k, dil):
    """One chain's weights: JAX layout [K, C_in, C_out] and biases."""
    w = lambda: (rng.normal(size=(k, c, c)) * 0.05).astype(np.float32)
    b = lambda: (rng.normal(size=(c,)) * 0.05).astype(np.float32)
    return [w() for _ in dil], [b() for _ in dil], [w() for _ in dil], [b() for _ in dil]


def _to_torch_chain(ch):
    k1, b1, k2, b2 = ch
    conv = lambda ws: [torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0)))
                       for w in ws]
    return conv(k1), [torch.from_numpy(b) for b in b1], conv(k2), \
        [torch.from_numpy(b) for b in b2]


def _ntc_to_nct(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 2, 1)))


@pytest.mark.parametrize("t,c,k", [(4096, 8, 11), (4096, 32, 3), (1000, 16, 7)])
def test_resblock_chain_plain_matches_direct_chain(t, c, k):
    from rvc_tpu.ops.resblock_pallas import _direct_chain

    rng = np.random.default_rng(t + c + k)
    x = (rng.normal(size=(1, t, c)) * 0.3).astype(np.float32)
    ch = _chain_np(rng, c, k, DIL)
    ref = _direct_chain(jnp.asarray(x), *[[jnp.asarray(a) for a in p] for p in ch],
                        DIL, 0.1)
    rb.reset_launches()
    out = rb.resblock_chain(_ntc_to_nct(x), *_to_torch_chain(ch), DIL, slope=0.1)
    assert rb.launches["resblock_chain"] == 0
    assert _rel(np.asarray(ref).transpose(0, 2, 1), out.numpy()) <= REL_TOL


@pytest.mark.parametrize("t,c", [(4096, 8), (4096, 32)])
def test_mrf_stage_plain_matches_direct_mrf(t, c):
    from rvc_tpu.ops.resblock_pallas import _direct_mrf

    rng = np.random.default_rng(t + c)
    x = (rng.normal(size=(1, t, c)) * 0.3).astype(np.float32)
    ks = (3, 7, 11)
    chains = [_chain_np(rng, c, k, DIL) for k in ks]
    ref = _direct_mrf(jnp.asarray(x),
                      [[[jnp.asarray(a) for a in p] for p in ch] for ch in chains],
                      ks, DIL, 0.1)
    rb.reset_launches()
    out = rb.mrf_stage(_ntc_to_nct(x), [_to_torch_chain(ch) for ch in chains],
                       ks, DIL, slope=0.1)
    assert rb.launches["mrf_stage"] == 0
    assert _rel(np.asarray(ref).transpose(0, 2, 1), out.numpy()) <= REL_TOL


def test_pallas_mrf_and_resblock_interpret_match_plain():
    """The TPU kernels themselves (interpret mode) agree with the port's
    plain versions: the two are the same function."""
    from rvc_tpu.ops.resblock_pallas import fused_mrf, fused_resblock

    rng = np.random.default_rng(1)
    t, c, ks, dil = 2048, 8, (3, 5), (1, 3)
    x = (rng.normal(size=(1, t, c)) * 0.3).astype(np.float32)
    chains = [_chain_np(rng, c, k, dil) for k in ks]
    jchains = [[[jnp.asarray(a) for a in p] for p in ch] for ch in chains]
    ref = fused_mrf(jnp.asarray(x), jchains, ks, dil, tile=512, interpret=True)
    out = rb.mrf_stage_plain(_ntc_to_nct(x), [_to_torch_chain(ch) for ch in chains],
                             dil, 0.1)
    assert _rel(np.asarray(ref).transpose(0, 2, 1), out.numpy()) <= REL_TOL
    ref = fused_resblock(jnp.asarray(x), *jchains[1], dil, tile=512,
                         interpret=True)
    out = rb.resblock_chain_plain(_ntc_to_nct(x), *_to_torch_chain(chains[1]),
                                  dil, 0.1)
    assert _rel(np.asarray(ref).transpose(0, 2, 1), out.numpy()) <= REL_TOL


def test_mrf_stage_plain_bf16_rounds_dot_operands():
    """The bf16 plain version is the f32 chain on bf16-rounded operands:
    within the JAX suite's bf16 tolerance (2e-2) of the f32 result."""
    rng = np.random.default_rng(2)
    t, c = 2048, 16
    x = (rng.normal(size=(1, c, t)) * 0.3).astype(np.float32)
    chains = [_to_torch_chain(_chain_np(rng, c, k, DIL)) for k in (3, 7, 11)]
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ref = rb.mrf_stage_plain(xb.float(), chains, DIL)
    out = rb.mrf_stage_plain(xb, chains, DIL)
    assert out.dtype == torch.bfloat16
    assert _rel(ref.numpy(), out.float().numpy()) <= 2e-2


@pytest.mark.parametrize("n,d", [(1000, 32), (5000, 64)])
def test_knn_plain_matches_jax(n, d):
    from rvc_tpu.ops.retrieval import knn_search

    rng = np.random.default_rng(n)
    q = rng.normal(size=(50, d)).astype(np.float32)
    v = rng.normal(size=(n, d)).astype(np.float32)
    d_ref, i_ref = knn_search(jnp.asarray(q), jnp.asarray(v), 8)
    rt.reset_launches()
    dist, idx = rt.knn_topk(torch.from_numpy(q), torch.from_numpy(v), 8)
    assert rt.launches["knn_topk"] == 0
    np.testing.assert_array_equal(np.asarray(i_ref), idx.numpy())
    assert _rel(d_ref, dist.numpy()) <= REL_TOL


def test_pallas_knn_interpret_matches_plain():
    from rvc_tpu.ops.retrieval_pallas import knn_search_pallas

    rng = np.random.default_rng(3)
    q = rng.normal(size=(16, 32)).astype(np.float32)
    v = rng.normal(size=(700, 32)).astype(np.float32)
    d_ref, i_ref = knn_search_pallas(jnp.asarray(q), jnp.asarray(v), 8,
                                     tile=248, interpret=True)
    dist, idx = rt.knn_search_plain(torch.from_numpy(q), torch.from_numpy(v), 8)
    np.testing.assert_array_equal(np.asarray(i_ref), idx.numpy())
    assert _rel(d_ref, dist.numpy()) <= REL_TOL


def test_retrieve_blend_matches_jax():
    from rvc_tpu.ops.retrieval import retrieve_blend as jax_blend

    rng = np.random.default_rng(4)
    feats = rng.normal(size=(40, 48)).astype(np.float32)
    vecs = rng.normal(size=(900, 48)).astype(np.float32)
    ref = jax_blend(jnp.asarray(feats), jnp.asarray(vecs), 0.75)
    out = rt.retrieve_blend(torch.from_numpy(feats), torch.from_numpy(vecs), 0.75)
    assert _rel(ref, out.numpy()) <= REL_TOL


def test_feature_index_roundtrip_and_search(tmp_path):
    """FeatureIndex over an array and over its .npz file searches and
    blends as the free functions do."""
    rng = np.random.default_rng(6)
    vecs = rng.normal(size=(300, 16)).astype(np.float32)
    feats = torch.from_numpy(rng.normal(size=(10, 16)).astype(np.float32))
    index = rt.FeatureIndex(vecs, device="cpu")
    path = str(tmp_path / "index.npz")
    index.save(path)
    loaded = rt.FeatureIndex.load(path, device="cpu")
    assert loaded.ntotal == 300
    d_ref, i_ref = rt.knn_search_plain(feats, torch.from_numpy(vecs), 8)
    dist, idx = loaded.search(feats)
    assert torch.equal(idx, i_ref) and torch.equal(dist, d_ref)
    assert torch.equal(loaded.blend(feats, 0.5),
                       rt.retrieve_blend(feats, torch.from_numpy(vecs), 0.5))


CHAIN_SETS = [((3, 7, 11), (1, 3, 5)), ((3, 7), (1, 3)), ((11,), (1, 3, 5))]


@pytest.mark.parametrize("ks,dil", CHAIN_SETS)
@pytest.mark.parametrize("c", [16, 32, 48, 64, 128])
def test_stage_plan_fits_the_block(c, ks, dil):
    """K1's geometry: a block's buffer is 32768 / cp rows (128 f32 state
    registers a consumer thread), it stores the rows a chain does not spoil,
    no tap reaches past the 32 guard rows, and the two bf16 planes, a
    ring of at least two 16 KB weight stages and the barriers fit the
    232,448 bytes a block may use. The accumulators leave a consumer at
    least 40 of its 240 registers, and the warpgroups' registers fit the
    SM's."""
    p = rb.stage_plan(c, ks, dil)
    assert p.cp == rb.padded_channels(c) and p.cp in rb.MRF_CHANNELS
    assert p.rows * p.cp == rb.MRF_BLOCK_ELEMS and p.rows % 128 == 0
    assert p.halo == max(k // 2 * sum(d + 1 for d in dil) for k in ks)
    assert p.cluster == rb.MRF_CLUSTER[p.cp] and 1 <= p.cluster <= 2
    assert p.tile == p.cluster * p.rows - 2 * p.halo and p.tile >= 1
    # a tap reaches into the neighbour's 32 edge rows at most (whole warps)
    assert max(k // 2 * d for k in ks for d in (*dil, 1)) <= rb.MRF_GUARD == 32
    assert 2 <= p.stages <= rb.MRF_MAX_STAGES
    assert p.smem == (2 * (p.rows + 2 * rb.MRF_GUARD) * p.cp * 2
                      + p.stages * rb.MRF_STAGE_BYTES
                      + (2 * rb.MRF_MAX_STAGES + 5) * 8)
    assert p.smem <= rb.SMEM_LIMIT
    # one more stage would not fit, or the ring is at its depth
    assert p.stages == rb.MRF_MAX_STAGES or \
        p.smem + rb.MRF_STAGE_BYTES > rb.SMEM_LIMIT
    # the state of 2 warpgroups x (256 / cp) bands of 64 rows: cp / 2
    # registers a band and thread
    assert 256 // p.cp * p.cp // 2 == rb.MRF_STATE_REGS
    assert p.regs == rb.MRF_STATE_REGS + rb.MRF_ACC_REGS
    assert p.regs + 40 <= rb.MRF_CONSUMER_REGS
    assert (rb.MRF_CONSUMERS * rb.MRF_CONSUMER_REGS
            + rb.MRF_PRODUCERS * rb.MRF_PRODUCER_REGS) <= rb.SM_REGISTERS


@pytest.mark.parametrize("c,ks,dil", [
    (256, (3, 7, 11), (1, 3, 5)),    # a wide stage: K2 per chain
    (128, (11, 11), (9, 27, 27, 27)),  # the chain spoils more rows than the buffer has
    (32, (3,), (1, 1, 1, 1, 1)),     # more dilations than the kernel takes
    (32, (11,), (1, 7)),             # a tap reaches 35 rows, over the 32 guard rows
    (64, (4,), (1,)),                # an even kernel size
])
def test_stage_plan_refuses_what_does_not_fit(c, ks, dil):
    with pytest.raises(ValueError):
        rb.stage_plan(c, ks, dil)


@pytest.mark.parametrize("c", [32, 64, 128])
def test_pack_conv_bf16_follows_operand_layout(c):
    """A conv's packed weights are the shared-memory images of wgmma's B
    operand, tap after tap: bf16 element ((tap * C/8 + ci // 8) * C + co) * 8
    + ci % 8 is W[co, ci, tap] (K-major, 16-byte depth groups of 8 input
    channels), so a 16 KB ring stage is a run of whole depth steps."""
    k = 5
    w = torch.randn((c, c, k), generator=torch.Generator().manual_seed(c))
    packed = rb.pack_conv_bf16(w)
    assert packed.dtype == torch.bfloat16 and packed.numel() == k * c * c
    wb = w.to(torch.bfloat16)
    rng = np.random.default_rng(c)
    for _ in range(300):
        tap, ci, co = rng.integers(k), rng.integers(c), rng.integers(c)
        flat = ((tap * (c // 8) + ci // 8) * c + co) * 8 + ci % 8
        assert float(packed[flat]) == float(wb[co, ci, tap])
    # every weight lands in exactly one slot
    assert torch.equal(torch.sort(packed.float()).values,
                       torch.sort(wb.float().reshape(-1)).values)
    # one (tap, 16-channel depth step) is 32 * C bytes, and a stage holds
    # a whole number of them
    assert rb.MRF_STAGE_BYTES % (32 * c) == 0


def test_pack_stage_orders_convs_and_pads():
    """The stage's stream is chain after chain, conv_d then conv_1 per
    dilation, each conv K * cp * cp bf16; a 48-channel stage packs at 64
    with zero weights and biases in the extra channels."""
    c, cp, ks, dil = 48, 64, (3, 7), (1, 3)
    rng = np.random.default_rng(12)
    chains = [_to_torch_chain(_chain_np(rng, c, k, dil)) for k in ks]
    packed = rb.pack_stage(chains, cp)
    assert packed.w.numel() == sum(2 * len(dil) * k * cp * cp for k in ks)
    assert packed.bias.shape == (2 * len(dil) * len(ks), cp)
    off = 0
    for ci, ((w1s, b1s, w2s, b2s), k) in enumerate(zip(chains, ks)):
        for di in range(len(dil)):
            for j, (w, b) in enumerate(((w1s[di], b1s[di]), (w2s[di], b2s[di]))):
                img = packed.w[off:off + k * cp * cp].reshape(k, cp // 8, cp, 8)
                back = img.permute(2, 1, 3, 0).reshape(cp, cp, k).float()
                assert torch.equal(back[:c, :c], w.to(torch.bfloat16).float())
                assert not back[c:].any() and not back[:, c:].any()
                row = packed.bias[(ci * len(dil) + di) * 2 + j]
                assert torch.equal(row[:c], b) and not row[c:].any()
                off += k * cp * cp


def _mrf_stage_tiled(x, chains, ks, dil, slope=0.1):
    """K1's tiling in plain torch, f32. Per (batch row, tile) the blocks of
    a cluster hold consecutive runs of ``rows`` rows of one buffer that
    starts ``halo`` rows before the tile. Each block keeps a plane of its
    rows between 32 guard rows; whoever writes a plane also writes its first
    and last 32 rows into the neighbours' guard rows (the
    guard rows at the buffer's two ends stay zero). Every conv computes ALL
    rows of every block from its own plane, the mask zeroes the rows
    outside [0, T) after every conv, and only rows [halo, halo + tile) of
    the buffer are stored."""
    b, c, t = x.shape
    p = rb.stage_plan(c, ks, dil)
    n, rows, g = p.cluster, p.rows, rb.MRF_GUARD
    out = torch.zeros_like(x)

    def write_planes(planes, values):
        """values[i]: block i's rows -> its plane and the neighbours' guards."""
        for i, v in enumerate(values):
            planes[i][:, :, g:g + rows] = v
            if i > 0:
                planes[i - 1][:, :, g + rows:] = v[:, :, :g]
            if i < n - 1:
                planes[i + 1][:, :, :g] = v[:, :, rows - g:]

    def conv(plane, w, bias, k, d):
        reach = k // 2 * d
        assert reach <= g
        return F.conv1d(plane[:, :, g - reach:g + rows + reach], w, bias, dilation=d)

    leaky = lambda v: torch.where(v >= 0, v, v * slope)
    for ti in range(-(-t // p.tile)):
        g0 = ti * p.tile - p.halo
        times = [torch.arange(g0 + i * rows, g0 + (i + 1) * rows) for i in range(n)]
        oks = [(tm >= 0) & (tm < t) for tm in times]
        total = [torch.zeros((b, c, rows)) for _ in range(n)]
        for (w1s, b1s, w2s, b2s), k in zip(chains, ks):
            ys = []
            for tm, ok in zip(times, oks):
                y = torch.zeros((b, c, rows))
                y[:, :, ok] = x[:, :, tm[ok]]
                ys.append(y)
            a1 = [torch.zeros((b, c, rows + 2 * g)) for _ in range(n)]
            a2 = [torch.zeros((b, c, rows + 2 * g)) for _ in range(n)]
            write_planes(a1, [leaky(y) for y in ys])
            for d, w1, b1, w2, b2 in zip(dil, w1s, b1s, w2s, b2s):
                ms = [conv(a1[i], w1, b1, k, d) * oks[i].float() for i in range(n)]
                write_planes(a2, [leaky(m) for m in ms])
                ys = [(ys[i] + conv(a2[i], w2, b2, k, 1)) * oks[i].float()
                      for i in range(n)]
                write_planes(a1, [leaky(y) for y in ys])
            total = [tot + y for tot, y in zip(total, ys)]
        whole = torch.cat(total, dim=2) / len(ks)
        lo, cnt = ti * p.tile, min(p.tile, t - ti * p.tile)
        out[:, :, lo:lo + cnt] = whole[:, :, p.halo:p.halo + cnt]
    return out


@pytest.mark.parametrize("b,c,t,ks,dil", [
    (2, 128, 1, (3, 7, 11), DIL), (2, 64, 77, (3, 7, 11), DIL),
    (1, 128, 391, (3, 7, 11), DIL), (1, 128, 393, (3, 7, 11), DIL),
    (1, 64, 903, (3, 7, 11), DIL), (1, 64, 905, (3, 7, 11), DIL),
    (2, 32, 903, (3, 7, 11), DIL), (2, 32, 905, (3, 7, 11), DIL),
    (2, 16, 9001, (3, 7, 11), DIL), (2, 48, 2001, (3, 7), (1, 3)),
])
def test_stage_tiling_matches_plain(b, c, t, ks, dil):
    """Tile by tile with the plan's cluster, halo, rows, guard-row exchange
    and masks, the stage is the plain stage on the whole signal (f32, 1e-6
    of the output's magnitude): T = 1, 77, one tile - 1 and + 1 at three
    widths, an odd T over several tiles, batch 2, a padded width, two chains
    with two dilations."""
    assert [rb.stage_plan(w, (3, 7, 11), DIL).tile for w in (128, 64, 32)] == \
        [392, 904, 904]
    rng = np.random.default_rng(b * 1000 + c + t)
    x = torch.from_numpy((rng.normal(size=(b, c, t)) * 0.3).astype(np.float32))
    chains = [_to_torch_chain(_chain_np(rng, c, k, dil)) for k in ks]
    ref = rb.mrf_stage_plain(x, chains, dil)
    out = _mrf_stage_tiled(x, chains, ks, dil)
    assert _rel(ref.numpy(), out.numpy()) <= 1e-6


@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("c", [64, 128, 256, 512])
def test_conv_plan_fits_shared_memory(c, k):
    """K2's conv kernel at every time tile it is built for and every
    dilation of the chain: the weight ring (at least 3 stages of 32 KB),
    two activation tiles of tile + (k - 1) d rows in two planes and the
    barriers fit the 232,448 bytes a block may use; the tile picked for the
    C=256 serving stage (T = 19176) is among them."""
    blocks = -(-c // rb.CONV_BLOCK)
    assert rb.conv_tile(19176, blocks) in rb.CONV_TILES
    for tile in rb.CONV_TILES:
        for d in (*DIL, 1):
            rows, stages, smem = rb.conv_plan(k, d, tile)
            assert rows == tile + (k - 1) * d
            assert 3 <= stages <= rb.CONV_MAX_STAGES
            assert smem == (stages * rb.CONV_STAGE_BYTES + 2 * 2 * rows * 32 * 4
                            + (2 * rb.CONV_MAX_STAGES + 4) * 8)
            assert smem <= rb.SMEM_LIMIT
            # one more stage would not fit, or the ring is at its depth
            assert stages == rb.CONV_MAX_STAGES or \
                smem + rb.CONV_STAGE_BYTES > rb.SMEM_LIMIT


@pytest.mark.parametrize("t,blocks,expected", [
    (19176, 2, 152),   # the C=256 serving stage: 254 blocks, two waves of 132
    (19176, 4, 152),   # C=512 there: 508 blocks, four waves (128: five)
    (11000, 2, 176),   # 126 blocks, one wave (152 and 128: two waves)
    (128 * 66, 2, 128),  # exactly one wave of 128-step tiles
    (3000, 1, 128),    # under one wave whatever the tile: the smallest
])
def test_conv_tile_wastes_least_of_the_last_wave(t, blocks, expected):
    def cost(tile):
        return -(-(-(-t // tile) * blocks) // 132) * tile
    tile = rb.conv_tile(t, blocks)
    assert tile == expected
    assert all(cost(tile) <= cost(other) for other in rb.CONV_TILES)


def test_split_tf32_is_exact():
    """big + small == w bit for bit in f32, big has its 13 low mantissa bits
    clear (it is what a tensor core reads of w), and small is below one
    tf32 ulp of w."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy((rng.normal(size=(4096,)) * 10.0 **
                          rng.integers(-6, 6, size=4096)).astype(np.float32))
    big, small = rb.split_tf32(w)
    assert torch.equal(big + small, w)
    assert not (big.view(torch.int32) & 0x1FFF).any()
    assert bool((small.abs() <= w.abs() * 2.0 ** -10).all())
    assert torch.equal(rb.split_tf32(big)[0], big)  # idempotent


@pytest.mark.parametrize("c_out,c_in,k", [(256, 256, 3), (200, 64, 5), (48, 32, 11)])
def test_pack_conv_tf32_follows_tile_layout(c_out, c_in, k):
    """The packed weights are the shared-memory images of K2's A tiles:
    flat index ((((((blk * n_chunks + chunk) * K + tap) * 2 + plane) * 8 + g)
    * 128 + row) * 4 + e) holds plane (big, small) of
    W[128 blk + row, 32 chunk + 4 g + e, tap], zero for rows past C_out."""
    w = torch.randn((c_out, c_in, k), generator=torch.Generator().manual_seed(k))
    packed = rb.pack_conv_tf32(w)
    blocks, chunks = -(-c_out // 128), c_in // 32
    assert packed.dtype == torch.float32
    assert packed.numel() == blocks * chunks * k * rb.CONV_STAGE_BYTES // 4
    big, small = rb.split_tf32(w)
    rng = np.random.default_rng(c_out)
    for _ in range(200):
        blk, chunk, tap = rng.integers(blocks), rng.integers(chunks), rng.integers(k)
        plane, g, row, e = rng.integers(2), rng.integers(8), rng.integers(128), rng.integers(4)
        flat = ((((((blk * chunks + chunk) * k + tap) * 2 + plane) * 8 + g) * 128
                 + row) * 4 + e)
        co, ci = 128 * blk + row, 32 * chunk + 4 * g + e
        want = 0.0 if co >= c_out else float((big, small)[plane][co, ci, tap])
        assert float(packed[flat]) == want
    # both planes together are the weights: nothing lost, nothing doubled
    planes = packed.reshape(blocks, chunks, k, 2, 8, 128, 4)
    whole = (planes[:, :, :, 0] + planes[:, :, :, 1]).permute(0, 4, 1, 3, 5, 2)
    assert torch.equal(whole.reshape(blocks * 128, c_in, k)[:c_out], w)


def test_pack_chain_pads_channels_and_keeps_the_chain():
    """A 48-channel chain packs at 64 input channels and one 128-row block,
    each conv as one run of its K taps (``conv_taps``: every tile holds
    them), the bias rows followed by a zero row (the bias of a conv's later
    runs); the convs rebuilt from the packed planes give the plain chain."""
    c, k, cp = 48, 7, 64
    rng = np.random.default_rng(9)
    w1s, b1s, w2s, b2s = _to_torch_chain(_chain_np(rng, c, k, DIL))
    packed = rb.pack_chain(w1s, b1s, w2s, b2s, cp, DIL)
    assert len(packed.ws) == 2 * len(DIL) and packed.bias.shape == (2 * len(DIL) + 1, 128)
    assert not packed.bias[-1].any()
    ws, bs = [], []
    for i, runs in enumerate(packed.ws):
        assert len(runs) == 1
        planes = runs[0].reshape(1, cp // 32, k, 2, 8, 128, 4)
        w = (planes[:, :, :, 0] + planes[:, :, :, 1]).permute(0, 4, 1, 3, 5, 2)
        w = w.reshape(128, cp, k)
        assert not w[c:].any() and not w[:, c:].any()
        ws.append(w[:c, :c].contiguous())
        assert not packed.bias[i, c:].any()
        bs.append(packed.bias[i, :c])
    x = torch.from_numpy((rng.normal(size=(1, c, 500)) * 0.3).astype(np.float32))
    ref = rb.resblock_chain_plain(x, w1s, b1s, w2s, b2s, DIL)
    out = rb.resblock_chain_plain(x, ws[0::2], bs[0::2], ws[1::2], bs[1::2], DIL)
    assert torch.equal(ref, out)


def test_three_tf32_products_keep_f32_precision():
    """The kernels' product, small*big + big*small + big*big with the small
    parts truncated to tf32 as the tensor cores read them, stays within
    1e-6 of the f32 dot product over a 2816-term sum (one tf32 product:
    1e-3)."""
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.normal(size=(64, 2816)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(2816, 64)).astype(np.float32))
    (ab, asm), (bb, bsm) = rb.split_tf32(a), rb.split_tf32(b)
    asm, bsm = rb.split_tf32(asm)[0], rb.split_tf32(bsm)[0]
    exact = a.double() @ b.double()
    three = (asm.double() @ bb.double() + ab.double() @ bsm.double()
             + ab.double() @ bb.double())
    one = ab.double() @ bb.double()
    scale = float(exact.abs().max())
    assert float((three - exact).abs().max()) / scale <= 1e-6
    assert float((one - exact).abs().max()) / scale >= 1e-5


@pytest.mark.parametrize("c,cp", [(4, 16), (16, 16), (24, 32), (48, 64), (100, 128)])
def test_channel_padding_is_exact(c, cp):
    """Narrow stages run padded to 16, 32 or a multiple of 64 channels with
    zero inputs, weights and biases: the padded chain's first c channels are
    the unpadded chain's, and the extra channels stay zero."""
    assert rb.padded_channels(c) == cp
    rng = np.random.default_rng(c)
    x = torch.from_numpy((rng.normal(size=(1, c, 300)) * 0.3).astype(np.float32))
    w1s, b1s, w2s, b2s = _to_torch_chain(_chain_np(rng, c, 5, DIL))
    ws, bs = [w for pair in zip(w1s, w2s) for w in pair], \
        [b for pair in zip(b1s, b2s) for b in pair]
    xp = torch.nn.functional.pad(x, (0, 0, 0, cp - c))
    wps, bps = rb._pad_weights(ws, bs, cp)
    out = rb.resblock_chain_plain(xp, wps[0::2], bps[0::2], wps[1::2], bps[1::2], DIL)
    ref = rb.resblock_chain_plain(x, w1s, b1s, w2s, b2s, DIL)
    assert _rel(ref.numpy(), out[:, :c].numpy()) <= REL_TOL
    assert not out[:, c:].any()


@pytest.mark.parametrize("n_q,n_v", [
    (799, 65536), (799, 10000), (301, 5003), (1, 5), (20000, 100000), (128, 129),
])
def test_knn_split_plan_covers_index(n_q, n_v):
    """Splits are runs of whole 128-row tiles that cover every index row
    once, none empty, and the grid of (128-query blocks) x splits fills the
    132 SMs with one block each where the index has the tiles for it."""
    n_split, rows = rt.split_plan(n_q, n_v)
    assert rows % 128 == 0 and n_split >= 1
    starts = [s * rows for s in range(n_split)]
    assert all(st < n_v for st in starts)                 # no empty split
    assert starts[-1] + rows >= n_v                       # the last row is covered
    covered = sum(min(n_v, st + rows) - st for st in starts)
    assert covered == n_v                                 # each row once
    q_blocks = -(-n_q // 128)
    assert q_blocks * n_split <= 132 or n_split == 1
    if (n_q, n_v) == (799, 65536):
        assert q_blocks * n_split >= 120


def test_weight_cache_reused_and_rebuilt():
    """The cache builds once for the same tensors and again after one of
    them is modified in place, replaced, or the extra key changes."""
    ws = [torch.randn(4, 4, 3) for _ in range(3)]
    cache, calls = WeightCache(), []

    def build():
        calls.append(1)
        return sum(w.sum() for w in ws)

    first = cache.get(ws, "key", build)
    assert cache.get(ws, "key", build) is first and cache.builds == 1
    ws[1].add_(1.0)                                  # in place: _version moves
    second = cache.get(ws, "key", build)
    assert cache.builds == 2 and second is not first
    ws[2] = ws[2].clone()                            # another tensor
    cache.get(ws, "key", build)
    cache.get(ws, "other", build)                    # another layout asked for
    assert cache.builds == 4 == len(calls)
    cache.get(ws, "other", build)
    assert cache.builds == 4


def test_resblock_folds_and_packs_once_for_inference():
    """With gradients off a ResBlock folds its weight norm once, a second
    call reuses the folded weights and the packed chain made from them, and
    a changed parameter rebuilds both; with gradients on nothing is cached
    (the folded weights carry the graph)."""
    from rvc_tpu_torch.models.commons import ResBlock

    torch.manual_seed(0)
    blk = ResBlock(32, 3, DIL)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn_like(p) * 0.1)
        a = blk.chain_weights()
        b = blk.chain_weights()
        assert blk._folded.builds == 1
        assert all(x is y for pa, pb in zip(a, b) for x, y in zip(pa, pb))
        pack = lambda cw: blk.packed.get(
            [t for part in cw for t in part], ("chain", 32),
            lambda: rb.pack_chain(*cw, 32, DIL))
        p1, p2 = pack(a), pack(blk.chain_weights())
        assert p1 is p2 and blk.packed.builds == 1
        blk.convs1[0].weight_g.mul_(2.0)
        c = blk.chain_weights()
        assert blk._folded.builds == 2 and c[0][0] is not a[0][0]
        assert torch.allclose(c[0][0], 2.0 * a[0][0])
        assert pack(c) is not p1 and blk.packed.builds == 2
        x = torch.randn(1, 32, 200)
        assert torch.equal(blk(x), rb.resblock_chain_plain(x, *c, DIL))
    w = blk.chain_weights()
    assert blk._folded.builds == 2 and w[0][0].requires_grad


def test_wrappers_reject_bad_input_before_launch():
    with pytest.raises(ValueError):
        rb._check_input(torch.zeros(1, 640, 100), "mrf_stage")  # over 512 channels
    with pytest.raises(ValueError):
        rb._check_input(torch.zeros(640, 100), "mrf_stage")  # not [B, C, T]
    with pytest.raises(TypeError):
        rb._check_input(torch.zeros(1, 8, 100, dtype=torch.float16), "mrf_stage")
