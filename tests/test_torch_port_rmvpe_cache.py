"""RMVPE's derived weights (``predictors/rmvpe.py``): each batch norm's
scale and shift and the BiGRU's stacked recurrent weights are built once per
weight version and input dtype, not on every forward. On the CPU with a tiny
``E2EModel``: the cached forward equals, bit for bit, the per-call formula
kept here (f32 and bf16); a warm forward builds nothing
(``rmvpe_norm_builds``) and packs nothing (``weight_packs``); an in-place
load, a cast and a deep copy each rebuild, and then give the new weights'
output; threads racing on a cold cache each read a whole entry. This file
imports no JAX: its ``cuda``-marked test runs on the card (``python -m
pytest --noconftest -m cuda -s tests/test_torch_port_rmvpe_cache.py``) at
the benchmark's RMVPE in bf16 and f32, and prints the kernels a warm
forward and a batch norm launch, a forward's host time and the cache
checks' host time.
"""

import _torch_threads  # noqa: F401  one CPU thread a process (see the module)

import contextlib
import copy
import json
import os
import statistics
import sys
import threading
import time

import pytest
import torch

from rvc_tpu_torch.predictors import rmvpe
from rvc_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E2E = dict(n_blocks=1, en_de_layers=2, inter_layers=1, en_out_channels=4, gru_hidden=16)


def _bn_per_call(self, x):
    scale = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
    shift = self.bias.float() - self.running_mean.float() * scale
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return x * scale.to(x.dtype).reshape(shape) + shift.to(x.dtype).reshape(shape)


def _gru_per_call(self, x):
    xi_f = x @ self.wi_fwd + self.bi_fwd
    xi_b = x @ self.wi_bwd + self.bi_bwd
    wh = torch.stack([self.wh_fwd, self.wh_bwd])
    bn = torch.stack([self.bhn_fwd, self.bhn_bwd])
    return rmvpe.bigru(xi_f, xi_b, wh, bn)


@contextlib.contextmanager
def _per_call():
    """The model's forward as it was before the caches: every derived
    weight rebuilt on every call."""
    bn, gru = rmvpe.BatchNorm.forward, rmvpe.FusedBiGRU.forward
    rmvpe.BatchNorm.forward, rmvpe.FusedBiGRU.forward = _bn_per_call, _gru_per_call
    try:
        yield
    finally:
        rmvpe.BatchNorm.forward, rmvpe.FusedBiGRU.forward = bn, gru


def _randomize(model, seed):
    """Random weights and running statistics (variances positive), loaded
    in place."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in model.state_dict().items():
        r = torch.randn(v.shape, generator=gen)
        sd[k] = (0.5 + r.abs() if k.endswith("running_var") else 0.3 * r).to(v.dtype)
    model.load_state_dict(sd)


def _model(dtype=torch.float32, seed=0, **cfg):
    model = rmvpe.E2EModel(**(cfg or E2E)).eval()
    _randomize(model, seed)
    return model.to(dtype=dtype)


def _mel(dtype, t=64, seed=1, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(1, t, rmvpe.N_MELS, generator=gen).to(device, dtype)


def _builds(run):
    """(result, the ``rmvpe_norm_builds`` and ``weight_packs`` counts of
    ``run()`` inside one request)."""
    with profiling.request(16000) as req:
        out = run()
    counters = req.as_dict()["counters"]
    return out, counters.get(rmvpe.BUILDS, 0), counters.get("weight_packs", 0)


def _n_caches(model):
    return sum(isinstance(m, (rmvpe.BatchNorm, rmvpe.FusedBiGRU)) for m in model.modules())


def _n_expected(n_blocks, en_de_layers, inter_layers, **_):
    """Two norms a ``ConvBlockRes``, one a transposed conv, the input's,
    and the BiGRU's stack."""
    return 2 * n_blocks * (2 * en_de_layers + inter_layers) + en_de_layers + 1 + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cached_forward_is_bit_identical(dtype):
    model, mel = _model(dtype), _mel(dtype)
    with _per_call():
        want = model(mel)
    first, second = model(mel), model(mel)
    assert torch.equal(first, want) and torch.equal(second, want)


def test_warm_forward_builds_nothing():
    model, mel = _model(), _mel(torch.float32)
    n = _n_caches(model)
    assert n == _n_expected(**E2E)
    _, cold, cold_packs = _builds(lambda: model(mel))
    _, warm, warm_packs = _builds(lambda: model(mel))
    assert (cold, warm) == (n, 0)
    assert cold_packs == warm_packs == 0            # the stage tails' counter is not RMVPE's


def _load_in_place(model):
    _randomize(model, seed=5)
    return model


def _cast(model):
    return model.to(torch.bfloat16)


@pytest.mark.parametrize("change", [_load_in_place, _cast, copy.deepcopy],
                         ids=["load_state_dict", "to_dtype", "deepcopy"])
def test_changed_weights_rebuild(change):
    model = _model()
    mel = _mel(torch.float32)
    model(mel)
    original = [m._folded._entry[1][0] for m in model.modules()
                if isinstance(m, rmvpe.BatchNorm)]
    changed = change(model)
    if change is copy.deepcopy:
        _randomize(changed, seed=5)                 # and the copy's own weights move
    dtype = next(changed.parameters()).dtype
    mel = mel.to(dtype)
    got, builds, _ = _builds(lambda: changed(mel))
    assert builds == _n_caches(changed)
    with _per_call():
        want = changed(mel)
    assert torch.equal(got, want)
    if change is copy.deepcopy:
        mine = [m._folded._entry[1][0] for m in changed.modules()
                if isinstance(m, rmvpe.BatchNorm)]
        assert all(a.data_ptr() != b.data_ptr() for a, b in zip(mine, original))
        _, builds, _ = _builds(lambda: model(mel))  # the original keeps its own
        assert builds == 0


def test_racing_threads_read_whole_entries():
    """Threads share one cold batch norm, half of them in f32 and half in
    bf16, so its one entry keeps changing key: each result still equals the
    per-call formula in its own dtype."""
    norm = rmvpe.BatchNorm(8)
    _randomize(norm, seed=3)
    xs = {dt: torch.randn(2, 8, 4, 6).to(dt) for dt in (torch.float32, torch.bfloat16)}
    with torch.no_grad():
        want = {dt: _bn_per_call(norm, x) for dt, x in xs.items()}
    bad, done = [], []

    def work(dt):
        with torch.no_grad():
            for _ in range(300):
                if not torch.equal(norm(xs[dt]), want[dt]):
                    bad.append(dt)
        done.append(dt)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(dt,))
                   for _ in range(6) for dt in xs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(done) == len(threads) and not bad


def test_forward_with_gradients_on_caches_no_graph():
    """RMVPE is inference-only: with gradients on around it, a forward still
    builds each entry once, and no cached tensor holds an autograd graph."""
    model, mel = _model(), _mel(torch.float32)
    with torch.enable_grad():
        _, cold, _ = _builds(lambda: model(mel))
        out, warm, _ = _builds(lambda: model(mel))
    assert (cold, warm) == (_n_caches(model), 0) and not out.requires_grad
    caches = [m._folded if isinstance(m, rmvpe.BatchNorm) else m._stacked
              for m in model.modules() if isinstance(m, (rmvpe.BatchNorm, rmvpe.FusedBiGRU))]
    cached = [t for cache in caches for t in cache._entry[1]]
    assert cached and all(not t.requires_grad and t.grad_fn is None for t in cached)


def _cuda_kernels(run) -> int:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def _check_us(model, x) -> float:
    """Host µs of the cache checks of one warm forward, every cache asked
    with the key its forward gives."""
    calls = []
    for m in model.modules():
        if isinstance(m, rmvpe.BatchNorm):
            calls.append((m._folded, (m.weight, m.bias, m.running_mean, m.running_var),
                           (x.dtype, x.device, 4)))
        elif isinstance(m, rmvpe.FusedBiGRU):
            calls.append((m._stacked, (m.wh_fwd, m.wh_bwd, m.bhn_fwd, m.bhn_bwd), None))
    costs = []
    for _ in range(7):
        t0 = time.perf_counter()
        for _ in range(50):
            for cache, tensors, extra in calls:
                cache.get(tensors, extra, None)
        costs.append((time.perf_counter() - t0) / 50 * 1e6)
    return min(costs)


def _timed(model, mel, n=10):
    """Median host ms to enqueue one forward, and to its end on the card."""
    host, wall = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(mel)
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    return round(statistics.median(host), 2), round(statistics.median(wall), 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,fewer", [(torch.bfloat16, 1000), (torch.float32, 500)])
def test_warm_forward_on_card(dtype, fewer):
    """The benchmark's RMVPE (``benchmark/configs/nsf48.json``) at T = 1 824
    on the card: the warm forward's salience equals the per-call formula's
    bit for bit, and launches at least ``fewer`` kernels fewer (a batch norm
    launches 13 kernels a call in bf16, 7 in f32, and 2 when warm)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    with open(os.path.join(REPO, "benchmark", "configs", "nsf48.json")) as f:
        cfg = json.load(f)["rmvpe"]
    model = _model(torch.float32, seed=11, **cfg).to("cuda", dtype)
    mel = _mel(dtype, t=1824, seed=12, device="cuda")
    norm, x = model.unet.encoder.layers[1].conv[0].conv[1], torch.randn(
        1, 32, 912, 64, device="cuda").to(dtype)
    counts, norm_counts, times = {}, {}, {}
    for name, ctx in (("per_call", _per_call), ("cached", contextlib.nullcontext)):
        with ctx():
            out = model(mel)
            model(mel)
            torch.cuda.synchronize()
            counts[name] = _cuda_kernels(lambda: model(mel))
            with torch.no_grad():
                norm_counts[name] = _cuda_kernels(lambda: norm(x))
            times[name] = _timed(model, mel)
        if name == "per_call":
            want = out
    assert _n_caches(model) == _n_expected(**cfg) == 119
    salience = model(mel)
    check = _check_us(model, mel[:, None])
    print(f"\nRMVPE {dtype} T=1824 ({torch.cuda.get_device_name(0)}): kernels a warm forward "
          f"{counts}, a batch norm {norm_counts}; host ms to enqueue a forward and to its "
          f"end {times}; cache checks {check:.1f} us a forward over {_n_caches(model)} caches")
    assert torch.equal(salience, want) and torch.equal(out, want)
    assert counts["per_call"] - counts["cached"] >= fewer
    assert norm_counts == {"per_call": 13 if dtype == torch.bfloat16 else 7, "cached": 2}
