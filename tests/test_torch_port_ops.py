"""The port's kernel modules on the CPU: each plain version against the JAX
package's function on the same numpy inputs, and the JAX package's Pallas
kernels (interpret mode) at a small size against the same plain versions.

Tolerance: f32 max abs error <= 1e-5 relative to the output's max magnitude
(only the summation order differs). CPU tensors take the plain path, so the
launch counters must stay 0. The CUDA kernels themselves are held against
these plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_tpu_torch.ops import resblock as rb
from rvc_tpu_torch.ops import retrieval as rt

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


@pytest.mark.parametrize("c,ks,ops_bf16,expected", [
    (32, (3, 7, 11), False, (4, 256)),
    (64, (3, 7, 11), False, (8, 256)),
    (128, (3, 7, 11), False, (4, 64)),
    (256, (11,), False, (0, 0)),     # a C=256 stage does not fit: K2 per chain
])
def test_stage_tile_fits_shared_memory(c, ks, ops_bf16, expected):
    """K1's geometry in f32 at the 48 kHz stage widths: 32 rows per warp row
    of the last conv, the widest channel tiling whose buffers fit."""
    nt, tile = rb.plan(c, ks, DIL, ops_bf16, mean=True)
    assert (nt, tile) == expected
    if tile:
        assert tile * (c // (8 * nt)) == rb.WARPS * rb.WARP_ROWS
        assert (tile + 2 * rb._halo(ks, DIL)) * (c + 4) * 8 <= rb.SMEM_LIMIT


@pytest.mark.parametrize("c", [32, 64, 128])
def test_pack_fragments_follows_mma_layout(c):
    """Each lane's four bf16 values are the B-fragment entries of
    mma.sync.m16n8k16: lane 4g + q holds c_out = 8 nt + g and
    c_in = 16 kc + (2q, 2q+1, 2q+8, 2q+9)."""
    k = 3
    w = torch.randn((c, c, k), generator=torch.Generator().manual_seed(c))
    packed = rb._pack_fragments([w], True).float().reshape(k, c // 16, c // 8, 32, 4)
    wb = w.to(torch.bfloat16).float()
    tap, kc, nt, lane = 2, c // 16 - 1, c // 8 - 1, 13
    g, q = lane // 4, lane % 4
    want = [wb[8 * nt + g, 16 * kc + ci, tap]
            for ci in (2 * q, 2 * q + 1, 2 * q + 8, 2 * q + 9)]
    assert packed[tap, kc, nt, lane].tolist() == [float(v) for v in want]
    # every weight lands in exactly one slot
    assert torch.equal(torch.sort(packed.reshape(-1)).values,
                       torch.sort(wb.reshape(-1)).values)


@pytest.mark.parametrize("c,ks,expected", [
    (128, (3, 7, 11), 128), (64, (3, 7, 11), 256), (32, (3, 7, 11), 256),
    (256, (3, 7, 11), 0), (48, (3,), 256),
])
def test_tensor_core_tile(c, ks, expected):
    """K1 in bf16 takes the serving stages at 32 rows per warp row; its
    buffers (f32 state and bf16 operand rows, padded by 8) fit shared
    memory. A 48-channel stage runs padded to 64."""
    nt, tile = rb.plan(c, ks, DIL, True, mean=True)
    assert tile == expected
    if tile:
        cp = rb.padded_channels(c)
        assert tile * (cp // (8 * nt)) == rb.WARPS * rb.WARP_ROWS
        assert (tile + 2 * rb._halo(ks, DIL)) * (cp + 8) * 6 <= rb.SMEM_LIMIT


def test_pack_fragments_f32_follows_mma_layout():
    """mma.sync.m16n8k8 (tf32) B fragments: lane 4g + q holds
    c_out = 8 nt + g and c_in = 8 kc + (q, q+4), in f32."""
    c, k = 128, 5
    w = torch.randn((c, c, k), generator=torch.Generator().manual_seed(5))
    packed = rb._pack_fragments([w], False).reshape(k, c // 8, c // 8, 32, 2)
    assert packed.dtype == torch.float32
    tap, kc, nt, lane = 4, 3, c // 8 - 1, 22
    g, q = lane // 4, lane % 4
    assert packed[tap, kc, nt, lane].tolist() == [
        float(w[8 * nt + g, 8 * kc + q, tap]), float(w[8 * nt + g, 8 * kc + q + 4, tap])]
    assert torch.equal(torch.sort(packed.reshape(-1)).values,
                       torch.sort(w.reshape(-1)).values)


@pytest.mark.parametrize("k,whole,pairs", [
    (3, 64, (96, 96, 96)), (7, 32, (96, 64, 64)), (11, 0, (64, 64, 48)),
])
def test_chain_tensor_core_tiles_at_c256(k, whole, pairs):
    """K2 at the C=256 serving stage: k=3 runs the whole chain in one
    launch, k=7 and k=11 one launch per dilation pair (whole-chain tiles
    under 64 rows), as the JAX kernel splits them."""
    assert rb.plan(256, (k,), DIL, False, mean=False) == ((8, whole) if whole else (0, 0))
    assert tuple(rb.plan(256, (k,), (d,), False, mean=False)[1] for d in DIL) == pairs
    for d, tile in zip(DIL, pairs):
        assert (tile + 2 * rb._halo((k,), (d,))) * 260 * 8 <= rb.SMEM_LIMIT


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
    xp, wps, bps = rb._pad_channels(x, ws, bs, cp)
    out = rb.resblock_chain_plain(xp, wps[0::2], bps[0::2], wps[1::2], bps[1::2], DIL)
    ref = rb.resblock_chain_plain(x, w1s, b1s, w2s, b2s, DIL)
    assert _rel(ref.numpy(), out[:, :c].numpy()) <= REL_TOL
    assert not out[:, c:].any()


def test_knn_split_plan_covers_index():
    n_split, rows = rt.split_plan(799, 65536)
    assert n_split * rows >= 65536 and (n_split - 1) * rows < 65536
    assert rows % 64 == 0 and -(-799 // 64) * n_split >= 132


def test_wrappers_reject_bad_input_before_launch():
    with pytest.raises(ValueError):
        rb._check_input(torch.zeros(1, 640, 100), "mrf_stage")  # over 512 channels
    with pytest.raises(ValueError):
        rb._check_input(torch.zeros(640, 100), "mrf_stage")  # not [B, C, T]
    with pytest.raises(TypeError):
        rb._check_input(torch.zeros(1, 8, 100, dtype=torch.float16), "mrf_stage")
