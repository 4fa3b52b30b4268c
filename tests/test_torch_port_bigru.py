"""RMVPE's BiGRU recurrence (``rvc_tpu_torch/ops/bigru.py``): the plain
step loop against the JAX package's ``FusedBiGRU`` (one ``lax.scan``), the
``nn.GRU`` weight mapping that ``chip_smoke.py`` times kernel G against, the
planner of G's geometry at every width, and the wrapper on the CPU.

Tolerances: f32 1e-5 absolute (the outputs lie in (-1, 1); the two sides sum
the products in different orders). bf16 2e-2 absolute: both sides carry h in
bf16 and round at every op, at different places (XLA may fuse ops and
round once where torch rounds after each). Kernel G itself runs only on the
card: ``test_kernel_matches_plain_on_card`` (marked ``cuda``; the card's
machine has no JAX, so this file imports it inside the one test that needs
it: ``python -m pytest --noconftest -m cuda tests/test_torch_port_bigru.py``
there) and ``chip_smoke.py`` hold it against ``bigru_plain`` there.
"""

import _torch_threads  # noqa: F401  one CPU thread a process (see the module)

import numpy as np
import pytest
import torch

from rvc_tpu_torch.ops import bigru as bg
from rvc_tpu_torch.predictors.rmvpe import FusedBiGRU, torch_gru_state_dict

F_IN = 24
T = 40
NAMES = ("wi", "bi", "wh", "bhn")


def _params(h, seed):
    """FusedBiGRU's parameters from numpy, by their JAX names."""
    rng = np.random.default_rng(seed)
    shapes = {"wi": (F_IN, 3 * h), "bi": (3 * h,), "wh": (h, 3 * h), "bhn": (h,)}
    scale = {"wi": F_IN ** -0.5, "bi": 0.1, "wh": 1.5 * h ** -0.5, "bhn": 0.1}
    return {f"{n}_{tag}": (scale[n] * rng.normal(size=shapes[n])).astype(np.float32)
            for tag in ("fwd", "bwd") for n in NAMES}


def _port_module(params, h, dtype=torch.float32):
    m = FusedBiGRU(F_IN, h)
    m.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    return m.to(dtype)


def _x(b, seed=7):
    return np.random.default_rng(seed).normal(size=(b, T, F_IN)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("h", [16, 32])
def test_plain_matches_jax_fused_bigru(h, b, dtype):
    """The port's FusedBiGRU (projections, then ``bigru`` -> ``bigru_plain``
    on the CPU) against JAX's, both in ``dtype``; in bf16 the JAX
    parameters are cast as ``rvc_tpu/infer/pipeline.py:270-277`` casts
    them."""
    import jax
    import jax.numpy as jnp

    from rvc_tpu.predictors.rmvpe import FusedBiGRU as FlaxBiGRU

    params, x = _params(h, seed=h + b), _x(b)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jparams = {k: jnp.asarray(v).astype(jdt) for k, v in params.items()}
    ref = jax.jit(FlaxBiGRU(hidden=h).apply)({"params": jparams}, jnp.asarray(x).astype(jdt))
    tdt = getattr(torch, dtype)
    with torch.no_grad():
        out = _port_module(params, h, tdt)(torch.from_numpy(x).to(tdt))
    assert out.shape == (b, T, 2 * h) and out.dtype == tdt
    err = np.abs(np.asarray(ref, np.float32) - out.float().numpy()).max()
    assert err <= (2e-2 if dtype == "bfloat16" else 1e-5), err


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("h", [16, 32])
def test_torch_gru_mapping_matches_plain(h, b):
    """torch ``nn.GRU`` (cuDNN's on the card: G's library yardstick) with
    FusedBiGRU's weights mapped by ``torch_gru_state_dict`` computes the
    same function as ``bigru_plain``, in f32."""
    m = _port_module(_params(h, seed=3 * h + b), h)
    gru = torch.nn.GRU(F_IN, h, bidirectional=True, batch_first=True)
    gru.load_state_dict(torch_gru_state_dict(m))
    x = torch.from_numpy(_x(b, seed=b))
    with torch.no_grad():
        ref = gru(x)[0]
        out = bg.bigru_plain(x @ m.wi_fwd + m.bi_fwd, x @ m.wi_bwd + m.bi_bwd,
                             torch.stack([m.wh_fwd, m.wh_bwd]),
                             torch.stack([m.bhn_fwd, m.bhn_bwd]))
    assert (ref - out).abs().max().item() <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [16, 32, 64, 128, 256, 384, 512, 1024])
def test_plan_takes_every_width(h, dtype):
    """No width or batch is refused. Every block owns at least one unit,
    the cluster's units cover H, the ks lanes of a unit lie in one warp and
    their 4-wide chunks lane + ks * j cover the padded h once; a block's
    threads fit the kernel's register bound and its shared memory (h, f32,
    double-buffered) the 227 KB a block may use. Wh stays in registers
    (kpt 16 or 32, one unit a thread) or is read from memory (kpt 0, units
    in passes)."""
    for b in (1, 8, 64):
        p = bg.plan(h, b, dtype)
        assert p.cluster in bg.CLUSTERS and p.units * p.cluster >= h
        assert (p.cluster - 1) * p.units < h
        assert p.rows in bg.ROW_CHOICES and p.rows * p.groups >= b
        assert p.rows * (p.groups - 1) < b
        assert 32 % p.ks == 0 and p.threads % 32 == 0
        assert p.threads <= bg.max_threads(p.kpt, p.rows) <= 1024
        chunks = sorted(lane + p.ks * j for lane in range(p.ks) for j in range(p.kchunks))
        assert chunks == list(range(p.ks * p.kchunks))
        assert p.kp == 4 * p.ks * p.kchunks >= h
        assert p.smem == 2 * p.rows * p.kp * 4 + 16 <= bg.SMEM_LIMIT == 232448
        if p.weights_in_registers:
            assert p.kpt in bg.KPT_CHOICES and p.kchunks == p.kpt // 4
            assert p.units * p.ks <= p.threads and p.passes == 1
        else:
            assert p.passes * (p.threads // p.ks) >= p.units
    # H = 256, every reference rmvpe.pt: Wh in registers, clusters of 16
    # where one wave holds them, of 8 at batch 64
    if h == 256:
        p = bg.plan(h, 1, dtype)
        assert (p.cluster, p.kpt, p.ks, p.units, p.threads) == (16, 32, 8, 16, 128)
        assert bg.plan(h, 64, dtype).cluster == 8


@pytest.mark.parametrize("h,cluster,kpt", [(256, 8, 32), (256, 4, 0), (256, 1, 0),
                                          (64, 2, 32), (20, 16, None)])
def test_plan_keeps_forced_choices(h, cluster, kpt):
    """A forced cluster size is kept where every block owns a unit, with Wh
    in registers where they hold it and read from memory (kpt 0) where
    they do not; a cluster that would leave a block none is refused."""
    if kpt is None:
        with pytest.raises(ValueError):
            bg.plan(h, 1, torch.float32, cluster=cluster)
        return
    p = bg.plan(h, 1, torch.float32, cluster=cluster)
    assert (p.cluster, p.kpt) == (cluster, kpt)


def test_cpu_wrapper_is_plain_and_refuses_gradients():
    """On the CPU ``bigru`` is ``bigru_plain``, and G launches nothing;
    a gradient request raises (no backward); mismatched shapes raise."""
    h = 16
    m = _port_module(_params(h, seed=1), h)
    x = torch.from_numpy(_x(2))
    xi_f, xi_b = x @ m.wi_fwd + m.bi_fwd, x @ m.wi_bwd + m.bi_bwd
    wh = torch.stack([m.wh_fwd, m.wh_bwd])
    bn = torch.stack([m.bhn_fwd, m.bhn_bwd])
    bg.reset_launches()
    with torch.no_grad():
        got = bg.bigru(xi_f, xi_b, wh, bn)
        assert torch.equal(got, bg.bigru_plain(xi_f, xi_b, wh, bn))
        assert torch.equal(m(x), got)
        with pytest.raises(ValueError):
            bg.bigru(xi_f[..., :-1], xi_b, wh, bn)
    assert bg.launches["bigru"] == 0
    with pytest.raises(RuntimeError, match="no backward"):
        m(x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,t,h", [("float32", 1, 1632, 256), ("bfloat16", 1, 1632, 256),
                                         ("float32", 3, 40, 16), ("bfloat16", 3, 77, 384),
                                         ("float32", 8, 300, 512)])
def test_kernel_matches_plain_on_card(dtype, b, t, h):
    """G against ``bigru_plain`` on the card, one launch, within 1e-5 (f32)
    and 2e-2 (bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("kernel G runs on a CUDA card only")
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(h + t)
    xi_f, xi_b = (torch.from_numpy(rng.normal(size=(b, t, 3 * h)).astype(np.float32))
                  .to("cuda", tdt) for _ in range(2))
    wh = torch.from_numpy((1.5 * h ** -0.5 * rng.normal(size=(2, h, 3 * h))).astype(
        np.float32)).to("cuda", tdt)
    bn = torch.from_numpy((0.1 * rng.normal(size=(2, h))).astype(np.float32)).to("cuda", tdt)
    bg.reset_launches()
    out = bg.bigru(xi_f, xi_b, wh, bn)
    torch.cuda.synchronize()
    assert bg.launches["bigru"] == 1
    err = (out.float() - bg.bigru_plain(xi_f, xi_b, wh, bn).float()).abs().max().item()
    assert err <= (2e-2 if dtype == "bfloat16" else 1e-5), err
