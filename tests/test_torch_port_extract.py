"""The port's feature extraction against the JAX package's, on the CPU.

Five clips of a preprocessed experiment (two speakers, 0.7-3.3 s) go
through both packages' ``extract`` subcommands from the same relative
``logs/m``, with a seeded ``models/predictors/rmvpe.pt`` in the reference
layout (a small RMVPE) and a narrow HF-layout embedder under
``models/embedders/contentvec/``. Both packages' loaders are pointed at
the small widths by monkeypatching; nothing else changes. Held:
- f0 within the RMVPE tolerance of ``test_rmvpe_infer_from_audio_matches_jax``
  (1e-3), the coarse f0 within one bin;
- features within 1e-4 of their peak, with the frame counts
  (len - 400) // 320 + 1;
- ``config.json``, ``model_info.json`` and ``filelist.txt`` (mute rows
  included): the same text;
- the other f0 methods (yin; crepe at hop 128) against JAX's;
- ``coarse_f0_train`` exactly; ``train`` builds the index at its end;
- extraction asked for on a card that is absent raises.
"""

import _torch_threads  # noqa: F401  one CPU thread a process (see the module)

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_tpu_torch import convert
from test_torch_port_f0 import _fix_var, _random_params, _voice
from test_torch_port_loading import _hf_state_dict
from test_torch_port_pipeline import E2E, HUB

CLIPS = [("0_0_0", 0.7), ("0_0_1", 3.3), ("0_1_0", 1.6), ("1_2_0", 2.05),
         ("1_2_1", 1.0)]


def test_coarse_f0_train_matches_jax():
    from rvc_tpu.train.extract import coarse_f0_train as jax_coarse
    from rvc_tpu_torch.train.extract import coarse_f0_train

    f0 = np.abs(np.random.default_rng(3).normal(300, 250, size=2000))
    f0[::7] = 0.0
    f0[5] = 2000.0
    out = coarse_f0_train(f0)
    np.testing.assert_array_equal(out, jax_coarse(f0))
    assert out.dtype == np.int64 and out.min() == 1 and out.max() == 255


def _small_reference_rmvpe(seed=0):
    """A seeded state_dict in the reference ``rmvpe.pt`` layout at the
    small widths: E2E names, an ``nn.GRU``, ``num_batches_tracked``."""
    from rvc_tpu_torch.predictors.rmvpe import E2EModel

    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in E2EModel(**E2E).state_dict().items()
              if not k.startswith("fc.0.gru.")}
    shapes.update({f"fc.0.gru.{k}": tuple(v.shape) for k, v in torch.nn.GRU(
        384, E2E["gru_hidden"], batch_first=True,
        bidirectional=True).state_dict().items()})
    sd = {}
    for k, shape in shapes.items():
        if k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, size=shape).astype(np.float32))
        else:
            sd[k] = torch.from_numpy((0.3 * rng.normal(size=shape)).astype(np.float32))
        if k.endswith("running_mean"):
            sd[k[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(7)
    return sd


def _stage_files(root):
    """models/predictors/{rmvpe,crepe}.pt and the contentvec embedder."""
    from rvc_tpu.embedders.hubert import FlaxHubert
    from rvc_tpu.embedders.hubert import HubertConfig as FHC
    from rvc_tpu.predictors.crepe import CrepeModel as FlaxCrepe

    pred = os.path.join(root, "models", "predictors")
    os.makedirs(pred)
    torch.save(_small_reference_rmvpe(), os.path.join(pred, "rmvpe.pt"))
    ev = _random_params(FlaxCrepe("tiny").init, jax.random.PRNGKey(0),
                        jnp.zeros((1, 1024)), seed=31)
    torch.save(convert.crepe_state_dict(ev["params"], _fix_var(ev["batch_stats"])),
               os.path.join(pred, "crepe.pt"))
    emb = os.path.join(root, "models", "embedders", "contentvec")
    os.makedirs(emb)
    params = _random_params(FlaxHubert(FHC(**HUB)).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 3200)), seed=32)["params"]
    torch.save(_hf_state_dict(params, "weight_g"), os.path.join(emb, "pytorch_model.bin"))


def _write_experiment(root):
    """logs/m as preprocess leaves it: 48 kHz and 16 kHz float WAVs."""
    from rvc_tpu_torch.utils.audio_io import resample, write_wav

    exp = os.path.join(root, "logs", "m")
    for i, (name, sec) in enumerate(CLIPS):
        wav16 = _voice(int(sec * 16000), seed=40 + i, f=150.0 + 40 * i)
        write_wav(os.path.join(exp, "sliced_audios_16k", f"{name}.wav"), wav16,
                  16000, "FLOAT")
        write_wav(os.path.join(exp, "sliced_audios", f"{name}.wav"),
                  resample(wav16, 16000, 48000), 48000, "FLOAT")
    return exp


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("staged"))
    _stage_files(root)
    return root


def _small_loaders(mp):
    """Both packages' RMVPE and embedder loaders at the small widths."""
    import rvc_tpu.embedders as jax_embedders
    from rvc_tpu.embedders.hubert import HubertConfig as FHC
    from rvc_tpu.embedders.hubert import load_embedder as jax_load
    from rvc_tpu.predictors.rmvpe import RMVPE as JaxRMVPE
    from rvc_tpu.predictors.rmvpe import E2EModel as FlaxE2E
    from rvc_tpu.predictors.rmvpe import _gru_params, convert_torch_rmvpe
    from rvc_tpu_torch.embedders import hubert
    from rvc_tpu_torch.predictors.rmvpe import RMVPE, E2EModel, state_dict_from_torch_rmvpe

    def jax_rmvpe(cls, path):
        sd = torch.load(path, weights_only=True)
        params, stats = convert_torch_rmvpe(sd, E2E["n_blocks"], E2E["en_de_layers"],
                                            E2E["inter_layers"])
        # the JAX converter reads the GRU at the default width
        sd_np = {k: v.numpy() for k, v in sd.items()}
        params = {**params, "bigru": jax.tree.map(jnp.asarray, _gru_params(
            sd_np, "fc.0.gru", E2E["gru_hidden"]))}
        return cls(params, stats, model=FlaxE2E(**E2E))

    def port_rmvpe(cls, path, device="cuda"):
        model = E2EModel(**E2E)
        model.load_state_dict(state_dict_from_torch_rmvpe(
            torch.load(path, weights_only=True)))
        return cls(model, device)

    port_load = hubert.load_embedder
    mp.setattr(JaxRMVPE, "from_torch_checkpoint", classmethod(jax_rmvpe))
    mp.setattr(RMVPE, "from_torch_checkpoint", classmethod(port_rmvpe))
    mp.setattr(jax_embedders, "load_embedder",
               lambda path, cfg=None: jax_load(path, FHC(**HUB)))
    mp.setattr(hubert, "load_embedder", lambda path, cfg=None, device="cuda":
               port_load(path, hubert.HubertConfig(**HUB), device))


ARGV = {"rmvpe": ["--batch_size", "2"], "yin": ["--batch_size", "3"],
        "crepe-tiny": ["--batch_size", "2", "--hop_length", "128"]}


@pytest.fixture(scope="module")
def extracted(staged, tmp_path_factory):
    """Each package's ``extract`` on its own copy of the experiment, per
    method, computed on first use: {(package, method): root}."""
    from rvc_tpu import cli as jax_cli
    from rvc_tpu_torch import cli

    cache = {}

    def run(pkg, method):
        if (pkg, method) not in cache:
            root = str(tmp_path_factory.mktemp(f"{pkg}_{method}"))
            shutil.copytree(os.path.join(staged, "models"), os.path.join(root, "models"))
            _write_experiment(root)
            argv = ["extract", "--model_name", "m", "--sample_rate", "48000",
                    "--f0_method", method, *ARGV[method]]
            cwd = os.getcwd()
            with pytest.MonkeyPatch.context() as mp:
                _small_loaders(mp)
                os.chdir(root)
                try:
                    if pkg == "jax":
                        assert jax_cli.main(argv) == 0
                    else:
                        assert cli.main(argv + ["--device", "cpu"]) == 0
                finally:
                    os.chdir(cwd)
            cache[pkg, method] = root
        return cache[pkg, method]

    return run


def _text(root, name):
    with open(os.path.join(root, "logs", "m", name)) as f:
        return f.read()


def _npy(root, sub, name):
    return np.load(os.path.join(root, "logs", "m", sub, name))


@pytest.mark.parametrize("method", ["rmvpe", "yin", "crepe-tiny"])
def test_extract_writes_what_jax_writes(extracted, method):
    ref, out = extracted("jax", method), extracted("port", method)
    for name in ("config.json", "model_info.json", "filelist.txt"):
        assert _text(out, name) == _text(ref, name), name
    rows = _text(out, "filelist.txt").strip().split("\n")
    assert len(rows) == len(CLIPS) + 2 * 2  # 2 mute rows for each of 2 speakers
    for name, sec in CLIPS + [("../mute", 3.0)]:
        sub = (lambda d: os.path.join("mute", d)) if name == "../mute" else (lambda d: d)
        stem = "mute" if name == "../mute" else name
        n16 = int(sec * 16000)
        f0r, f0o = (_npy(r, sub("f0_voiced"), f"{stem}.wav.npy") for r in (ref, out))
        assert f0o.shape == f0r.shape == (n16 // 160 + 1,) and f0o.dtype == np.float64
        np.testing.assert_allclose(f0o, f0r, rtol=1e-3, atol=1e-3, err_msg=stem)
        cr, co = (_npy(r, sub("f0"), f"{stem}.wav.npy") for r in (ref, out))
        assert np.abs(cr - co).max() <= 1
        er, eo = (_npy(r, sub("extracted"), f"{stem}.npy") for r in (ref, out))
        assert eo.shape == er.shape == ((n16 - 400) // 320 + 1, HUB["hidden_size"])
        assert np.isfinite(eo).all()
        assert np.abs(er - eo).max() <= 1e-4 * np.abs(er).max(), stem
    assert all((_npy(out, "f0_voiced", f"{n}.wav.npy") > 0).sum() > 40
               for n, _ in CLIPS)


def test_extract_on_an_absent_card_raises(tmp_path):
    from rvc_tpu_torch.train.extract import run_extraction

    if torch.cuda.is_available():
        pytest.skip("a card is present: the extraction would run on it")
    exp = _write_experiment(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_extraction(exp, f0_method="yin")


def test_train_builds_the_index_at_its_end(tmp_path, monkeypatch):
    """``train`` on the CPU (the tiny configuration of the trainer's tests)
    writes the index JAX's ``build_index`` writes for the same features."""
    from rvc_tpu.train.index_builder import build_index as jax_build
    from rvc_tpu_torch import cli
    from rvc_tpu_torch.train import trainer as trainer_mod
    from test_torch_port_train_trainer import small_mpd, tiny_cfg, write_dataset

    exp = tmp_path / "logs" / "m"
    exp.mkdir(parents=True)
    write_dataset(str(exp), n=4, seed=2)
    (exp / "extracted").mkdir()
    for i in range(4):
        shutil.copy(exp / f"{i}.feats.npy", exp / "extracted" / f"0_{i}_0.npy")
    ref_exp = tmp_path / "ref" / "m"
    shutil.copytree(exp / "extracted", ref_exp / "extracted")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(trainer_mod, "MultiPeriodDiscriminator", small_mpd)
    monkeypatch.setattr(cli, "train_config", lambda args: dataclasses.replace(
        tiny_cfg(), train=dataclasses.replace(tiny_cfg().train,
                                              use_multiscale_mel=False)))
    assert cli.main(["train", "--model_name", "m", "--sample_rate", "48000",
                     "--total_epoch", "1", "--save_every_epoch", "1",
                     "--pretrained", "False", "--device", "cpu"]) == 0
    with np.load(exp / "m.index.npz") as z, np.load(jax_build(str(ref_exp))) as r:
        np.testing.assert_array_equal(z["vectors"], r["vectors"])
