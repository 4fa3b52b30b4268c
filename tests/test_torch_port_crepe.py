"""The port's CREPE against the benchmark's plain reference
(``benchmark/reference/crepe.py``), on the CPU with seeded weights: the
salience of ``CrepeModel`` at capacity tiny and at full's structure with
narrower filters, on 100-300 frames, within 1e-5; the same Viterbi path and
f0 from ``CREPE.predict``; the batch norms at torchcrepe's epsilon; and
``Pipeline.pipeline`` with ``f0_method="crepe"`` on an input cut into three
windows, held stage by stage and window by window to the reference's steps
(``benchmark/windowed.py``'s comparison). This file imports no JAX."""

import _torch_threads  # noqa: F401  one CPU thread a process (see the module)

import json
import os

import numpy as np
import pytest
import torch

from benchmark import weights, windowed
from benchmark.reference import crepe as ref
from benchmark.traffic import Request, voice
from rvc_tpu_torch.predictors import crepe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIGNAL = {**weights.CALIBRATION_SIGNAL, "f0_hz": [110, 660]}
MIX = {"settings": {"pitch_shift": 2, "index_rate": 0.75, "protect": 0.33,
                    "filter_radius": 3, "sid": 0},
       "windows": {"x_pad": 1, "x_query": 1, "x_center": 2, "x_max": 3}}


def _arch(mult):
    return {"filters": [f * mult for f in crepe.BASE_FILTERS], "kernels": list(crepe.KERNELS),
            "strides": list(crepe.STRIDES), "classifier": [64 * mult, 360], "hop": 160}


def _seeded(capacity, mult, seed, monkeypatch):
    """A CREPE predictor at ``mult`` times the base filters, its weights by
    the benchmark's rules and its batch norms calibrated by the reference."""
    monkeypatch.setitem(crepe.CAPACITIES, capacity, mult)
    model = crepe.CrepeModel(capacity)
    sd = weights.seeded_state(weights.float_shapes(model), seed, "crepe", "cpu")
    rng = np.random.default_rng(seed)
    ref.calibrate(sd, torch.from_numpy(voice(16000, rng, SIGNAL)), _arch(mult))
    model.load_state_dict(sd, strict=False)
    return crepe.CREPE(capacity, model, device="cpu"), sd


@pytest.mark.parametrize("capacity, mult, samples", [("tiny", 4, 16000), ("full", 2, 47840)])
def test_salience_path_and_f0_match_the_reference(capacity, mult, samples, monkeypatch):
    """Capacity tiny on 101 frames; full's structure at 2x the base filters
    (64, 8, 8, 8, 16, 32) on 300 frames."""
    pred, sd = _seeded(capacity, mult, 7, monkeypatch)
    assert {m.eps for m in pred.model.modules()
            if isinstance(m, torch.nn.BatchNorm2d)} == {ref.BN_EPS}
    audio = voice(samples, np.random.default_rng(8), SIGNAL)
    frames = ref.frames_of(torch.from_numpy(audio))
    want = ref.salience(sd, frames, _arch(mult), block=64)
    got = pred.salience(frames)
    assert got.shape == want.shape == (samples // 160 + 1, 360)
    assert float((got - want).norm() / want.norm()) <= 1e-5
    assert float(want.std()) > 0.05             # calibrated: a salience with contrast

    masked = ref.masked(want, 50.0, 1100.0)
    np.testing.assert_array_equal(crepe._viterbi_path(masked.numpy()),
                                  ref.viterbi(masked).numpy())
    f0 = pred.predict(audio)
    np.testing.assert_allclose(f0, ref.decode(got, 50.0, 1100.0).numpy(), rtol=1e-5)


def _salience(frames, kind, silent):
    rng = np.random.default_rng(frames)
    sal = rng.random((frames, 360))
    if kind == "peaked":
        centre = 180 + (90 * np.sin(np.arange(frames) / 9)).astype(int)
        sal = np.exp(-0.5 * ((np.arange(360)[None] - centre[:, None]) / 3.0) ** 2)
    if silent:
        sal[::7] = 0.0
    masked = ref.masked(torch.from_numpy(sal.astype(np.float32)), 50.0, 1100.0)
    return masked


@pytest.mark.parametrize("frames, kind", [(1, "random"), (2, "random"), (400, "random"),
                                           (400, "peaked")])
def test_viterbi_path_matches_the_reference(frames, kind):
    """The host Viterbi's path against the reference's dense one: random
    salience, and a peaked one whose path moves by up to 10 bins a frame."""
    masked = _salience(frames, kind, silent=False)
    np.testing.assert_array_equal(crepe._viterbi_path(masked.numpy()),
                                  ref.viterbi(masked).numpy())


def _shifted_path(sal):
    """The step as 23 shifted adds into a candidate array, argmax over the
    shifts, back pointers kept for every frame."""
    t, n = sal.shape
    offs = np.arange(-11, 12)
    w_band = (12 - np.abs(offs)).astype(np.float64)
    logw, log_rowsum = np.log(w_band), np.log(np.convolve(np.ones(n), w_band, mode="same"))
    obs = sal.astype(np.float64)
    log_obs = np.log(obs / np.maximum(obs.sum(axis=1, keepdims=True), 1e-12) + 1e-12)
    dp, back, cols = np.full(n, np.log(1.0 / n)) + log_obs[0], np.zeros((t, n), np.int64), np.arange(n)
    for i in range(1, t):
        a, cand = dp - log_rowsum, np.full((len(offs), n), -np.inf)
        for k, o in enumerate(offs):
            if o >= 0:
                cand[k, o:] = a[:n - o] + logw[k]
            else:
                cand[k, :n + o] = a[-o:] + logw[k]
        best = cand.argmax(axis=0)
        dp, back[i] = cand[best, cols] + log_obs[i], cols - offs[best]
    path = np.zeros(t, np.int64)
    path[-1] = dp.argmax()
    for i in range(t - 2, -1, -1):
        path[i] = back[i + 1, path[i + 1]]
    return path


@pytest.mark.parametrize("kind", ["random", "peaked"])
def test_viterbi_ties_break_as_the_shifted_step(kind):
    """Silent frames make whole rows of equal observations, so the step's
    argmax meets ties: the path breaks them as the 23 shifted adds with an
    argmax over the shifts do, to the bin (the reference's dense
    transition matrix rounds differently there)."""
    sal = _salience(400, kind, silent=True).numpy()
    np.testing.assert_array_equal(crepe._viterbi_path(sal), _shifted_path(sal))


def test_full_capacity_is_torchcrepes():
    arch = _arch(crepe.CAPACITIES["full"])
    with open(os.path.join(REPO, "benchmark", "configs", "crepe48.json")) as f:
        f0 = json.load(f)["f0"]
    assert {k: f0[k] for k in arch if k != "hop"} == {k: v for k, v in arch.items() if k != "hop"}
    assert f0["bn_eps"] == crepe.BN_EPS == ref.BN_EPS
    n = sum(p.numel() for p in crepe.CrepeModel("full").parameters())
    assert round(n / 1e6, 2) == 22.24


def test_windowed_crepe_conversion_matches_the_reference():
    """``Pipeline.pipeline`` with CREPE (tiny) on a 4.5 s input cut into
    three windows: the salience, each window's features, synthesizer inputs
    and output, against the reference's steps."""
    with open(os.path.join(REPO, "benchmark", "tests", "data", "tinycrepe.json")) as f:
        config = json.load(f)
    built = windowed.build(config, MIX, 11, torch.device("cpu"))
    pipe = built["pipe"]
    recorder = windowed.Recorder(pipe, "crepe", built["f0_model"], {0},
                                 windowed.serve.HostPool(0, False))
    audio = voice(72000, np.random.default_rng(12), SIGNAL)
    req = Request(0, 0, audio, 13)
    recorder.begin(req)
    out = pipe.pipeline(audio, sid=0, pitch_shift=2, f0_method="crepe",
                        index_vectors=built["index"], index_rate=0.75, protect=0.33,
                        filter_radius=3, predictors=built["predictors"],
                        generator=torch.Generator().manual_seed(13))
    recorder.end(out)
    record = recorder.kept[0]
    assert len(record["synth_in"]) == len(record["hubert"]) == 3
    sd = windowed.model_states(config, built["shapes"], 11, "cpu")
    gaps = windowed.gaps(sd, built["index"], config, MIX, record, torch.device("cpu"))
    assert gaps["salience_vs_bf16"] <= 0.01
    assert all(gaps[n] <= 1e-4 for n in ("features_gap", "synth_inputs_gap", "output_gap"))
    # a salience a hundredth off is caught
    record["f0"] = [t * 0.99 for t in record["f0"]]
    bad = windowed.gaps(sd, built["index"], config, MIX, record, torch.device("cpu"))
    assert bad["salience_vs_bf16"] > 1.0
