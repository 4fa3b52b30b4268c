"""The port's loaders against the JAX package's, on the CPU in float32.

The same files, written in the reference formats from seeded random
weights, go through the JAX loader and the port's:
- a small 48 kHz ``.pth`` (fp16 under "weight", the 18-element config),
  with and without pitch (``f0`` 1 and 0) and in both weight-norm key
  spellings: the same architecture, the same effective weights (1e-6), and
  one ``Synthesizer.infer`` within 1e-4 relative;
- a full training checkpoint without config (sample rate from the decoder's
  shapes) and a refused discriminator checkpoint;
- faiss IndexFlat / IndexIVFFlat files: the same vectors; truncated or
  unknown files raise;
- an HF-layout HuBERT (``.bin`` and ``.safetensors``): features within 1e-4;
- the reference ``rmvpe.pt`` layout at the default widths: exactly the
  parameters ``convert.rmvpe_state_dict(*convert_torch_rmvpe(sd))`` gives,
  and a small model's ``infer_from_audio`` within 1e-3.
"""

import _torch_threads  # noqa: F401  one CPU thread a process (see the module)

import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_tpu_torch import convert
from test_torch_port_models import _fix_var, _random_params, _rel
from test_torch_port_pipeline import E2E, HUB, SYN

# the small model's config-list fields (the reference's positional layout)
ARCH = {k: SYN[k] for k in (
    "inter_channels", "hidden_channels", "filter_channels", "n_heads",
    "n_layers", "kernel_size", "resblock_kernel_sizes", "resblock_dilation_sizes",
    "upsample_rates", "upsample_initial_channel", "upsample_kernel_sizes",
    "spk_embed_dim", "gin_channels", "text_enc_hidden_dim")}


def _flax_synth(use_f0, seed):
    from rvc_tpu.models.synthesizer import Synthesizer as FlaxSynth

    fsyn = FlaxSynth(spec_channels=33, segment_size=8, posterior_layers=2,
                     flow_layers=2, zero_noise=True, use_f0=use_f0, **SYN)
    t = 12
    params = _random_params(
        fsyn.init, {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, t, 32)), jnp.asarray([t], jnp.int32),
        jnp.full((1, t), 100, jnp.int32) if use_f0 else None,
        jnp.full((1, t), 220.0, jnp.float32) if use_f0 else None,
        jnp.zeros((1, t, 33)), jnp.asarray([t], jnp.int32),
        jnp.zeros((1,), jnp.int32), seed=seed)["params"]
    return fsyn, params


def _pad_nsf_keys(params):
    """A no-F0 tree with a dummy sine source and noise convs: the JAX
    exporter and loader read ``dec.m_source`` and ``dec.noise_convs``
    unconditionally (ROADMAP §C), so the f0=0 file is written through this
    tree and those keys are stripped from the file afterwards."""
    dec = dict(params["dec"])
    dec["m_source"] = {"l_linear": {"kernel": np.zeros((1, 1), np.float32),
                                    "bias": np.zeros((1,), np.float32)}}
    for i in range(len(SYN["upsample_rates"])):
        dec[f"noise_convs_{i}"] = {"kernel": np.zeros((1, 1, 1), np.float32),
                                   "bias": np.zeros((1,), np.float32)}
    return {**params, "dec": dec}


def _is_nsf_only(key):
    return key.startswith(("dec.m_source.", "dec.noise_convs."))


def _write_pth(path, params, use_f0, spelling):
    from rvc_tpu.configs import get_config
    from rvc_tpu.utils.export_torch import export_rvc_pth

    cfg = get_config(48000, use_f0=use_f0, **ARCH)
    export_rvc_pth(params if use_f0 else _pad_nsf_keys(params), str(path),
                   sr=48000, cfg=cfg, metadata={"f0": int(use_f0)})
    cpt = torch.load(str(path), weights_only=True)
    w = {k: v for k, v in cpt["weight"].items() if use_f0 or not _is_nsf_only(k)}
    if spelling == "parametrizations":
        w = {k.replace(".weight_g", ".parametrizations.weight.original0")
              .replace(".weight_v", ".parametrizations.weight.original1"): v
             for k, v in w.items()}
    torch.save({**cpt, "weight": w}, str(path))


def _jax_load(path, use_f0):
    """The JAX package's loader; for a no-F0 file its converter runs on the
    weights padded with the dummy NSF keys, which are dropped after."""
    from rvc_tpu.utils.checkpoints import convert_torch_synthesizer, load_rvc_pth

    if use_f0:
        return load_rvc_pth(str(path))
    cpt = torch.load(str(path), weights_only=True)
    sd = dict(cpt["weight"])
    sd["dec.m_source.l_linear.weight"] = torch.zeros(1, 1)
    sd["dec.m_source.l_linear.bias"] = torch.zeros(1)
    for i in range(len(SYN["upsample_rates"])):
        sd[f"dec.noise_convs.{i}.weight"] = torch.zeros(1, 1, 1)
        sd[f"dec.noise_convs.{i}.bias"] = torch.zeros(1)
    params = jax.tree.map(np.asarray, convert_torch_synthesizer(
        sd, n_ups=len(SYN["upsample_rates"]),
        num_kernels=len(SYN["resblock_kernel_sizes"])))
    params["dec"] = {k: v for k, v in params["dec"].items()
                     if k != "m_source" and not k.startswith("noise_convs")}
    meta = {k: cpt.get(k) for k in ("config", "sr", "f0", "version", "vocoder")}
    return params, meta


def _effective(model):
    """Every weight as the module uses it: weight norm applied."""
    from rvc_tpu_torch.models.commons import weight_norm

    sd = model.state_dict()
    out = {k: v for k, v in sd.items() if not k.endswith((".weight_g", ".weight_v"))}
    for k in sd:
        if k.endswith(".weight_v"):
            base = k[:-len(".weight_v")]
            out[f"{base}.weight"] = weight_norm(sd[k], sd[f"{base}.weight_g"])
    return out


def _zero_noise(model):
    model.zero_noise = True
    if model.use_f0:
        model.dec.m_source.l_sin_gen.zero_noise = True


def _infer_both(fsyn, jparams, model, use_f0):
    from rvc_tpu.models.synthesizer import Synthesizer as FlaxSynth

    rng = np.random.default_rng(7)
    t = 20
    phone = rng.normal(size=(1, t, 32)).astype(np.float32)
    pitch = rng.integers(1, 255, size=(1, t)).astype(np.int32)
    f0 = (100 + 200 * rng.random((1, t))).astype(np.float32)
    lengths, sid = np.array([t - 2], np.int32), np.array([1], np.int32)
    ref, _ = fsyn.apply(
        {"params": jparams}, jnp.asarray(phone), jnp.asarray(lengths),
        jnp.asarray(pitch) if use_f0 else None, jnp.asarray(f0) if use_f0 else None,
        jnp.asarray(sid), method=FlaxSynth.infer, rngs={"noise": jax.random.PRNGKey(0)})
    out, _ = model.infer(torch.from_numpy(phone), torch.from_numpy(lengths).long(),
                         torch.from_numpy(pitch).long(), torch.from_numpy(f0),
                         torch.from_numpy(sid).long(), temperature=0.0)
    return np.asarray(ref), out.numpy()


@pytest.mark.parametrize("use_f0", [True, False])
@pytest.mark.parametrize("spelling", ["weight_g", "parametrizations"])
def test_pth_loads_as_in_jax(tmp_path, use_f0, spelling):
    from rvc_tpu.utils.checkpoints import derive_synth_arch as jax_arch
    from rvc_tpu_torch.models.synthesizer import Synthesizer
    from rvc_tpu_torch.utils.checkpoints import (build_synthesizer,
                                                 derive_synth_arch, load_rvc_pth)

    fsyn, params = _flax_synth(use_f0, seed=31 + use_f0)
    path = tmp_path / "model.pth"
    _write_pth(path, params, use_f0, spelling)
    jparams, jmeta = _jax_load(path, use_f0)
    sd, meta = load_rvc_pth(str(path))
    assert sd["enc_p.emb_phone.weight"].dtype == torch.float32
    assert meta["sr"] == 48000 and meta["f0"] == int(use_f0)

    j_over, j_flow = jax_arch(jparams, jmeta)
    over, flow = derive_synth_arch(sd, meta)
    assert over.pop("text_enc_hidden_dim") == np.asarray(
        jparams["enc_p"]["emb_phone"]["kernel"]).shape[0] == 32
    assert over == j_over and flow == j_flow == 2

    model, cfg, got_f0 = build_synthesizer(sd, meta, device="cpu")
    assert got_f0 == use_f0 and cfg.data.sample_rate == 48000
    assert model.dec.ups[0].weight_v.shape[-1] == 24
    ref_model = Synthesizer(flow_layers=2, use_f0=use_f0, **SYN)
    convert.load_into(ref_model, convert.synthesizer_state_dict(jparams))
    got, want = _effective(model), _effective(ref_model)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)

    _zero_noise(model)
    ref, out = _infer_both(fsyn, jparams, model, use_f0)
    assert out.shape == ref.shape == (1, 20 * 480, 1)
    assert _rel(ref, out) <= 1e-4


def test_full_training_checkpoint_infers_48k(tmp_path):
    """{"model": sd} without config or sample rate: 48 kHz from the kernel
    size of dec.ups.0, the preset's architecture, pitch guidance."""
    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.models.synthesizer import Synthesizer
    from rvc_tpu_torch.utils.checkpoints import build_synthesizer, load_rvc_pth

    src = Synthesizer.from_config(get_config(48000), device="cpu")
    rng = np.random.default_rng(3)
    sd = {k: torch.from_numpy((0.02 * rng.normal(size=tuple(v.shape))).astype(np.float32))
          for k, v in src.state_dict().items()}
    sd["enc_q.pre.weight"] = torch.zeros(192, 1025, 1)  # posterior: skipped
    path = tmp_path / "G_100.pth"
    torch.save({"model": sd, "iteration": 100, "learning_rate": 1e-4}, str(path))
    loaded, meta = load_rvc_pth(str(path))
    assert meta["sr"] == 48000 and meta["config"] is None
    model, cfg, use_f0 = build_synthesizer(loaded, meta, device="cpu")
    assert use_f0 and cfg.upsample_factor == 480
    t = 6
    audio, _ = model.infer(torch.zeros(1, t, 768), torch.tensor([t]),
                           torch.full((1, t), 50), torch.full((1, t), 200.0),
                           torch.tensor([0]), generator=torch.Generator().manual_seed(0))
    assert audio.shape == (1, t * 480, 1) and torch.isfinite(audio).all()


def test_discriminator_checkpoint_refused(tmp_path):
    from rvc_tpu_torch.utils.checkpoints import load_rvc_pth

    path = tmp_path / "D_100.pth"
    torch.save({"model": {"discriminators.0.convs.0.weight_v": torch.zeros(4, 1, 3)},
                "iteration": 100}, str(path))
    with pytest.raises(ValueError, match="discriminator"):
        load_rvc_pth(str(path))


def test_npz_checkpoint_loads(tmp_path):
    """The JAX package's own .npz: read with numpy, carried across by
    ``convert.synthesizer_state_dict``."""
    from rvc_tpu.utils.checkpoints import save_checkpoint
    from rvc_tpu_torch.utils.checkpoints import build_synthesizer, load_checkpoint

    _, params = _flax_synth(True, seed=5)
    path = tmp_path / "model.npz"
    save_checkpoint(str(path), {"model": params},
                    {"sample_rate": 48000, "f0": 1, "config": None})
    tree, meta = load_checkpoint(str(path))
    sd = convert.synthesizer_state_dict(tree["model"])
    meta = {**meta, "speakers_id": int(sd["emb_g.weight"].shape[0]),
            "config": [33, 36, *[SYN[k] for k in ("inter_channels", "hidden_channels",
                                                  "filter_channels", "n_heads",
                                                  "n_layers", "kernel_size")],
                       0.0, "1", list(SYN["resblock_kernel_sizes"]),
                       [list(d) for d in SYN["resblock_dilation_sizes"]],
                       list(SYN["upsample_rates"]), SYN["upsample_initial_channel"],
                       list(SYN["upsample_kernel_sizes"]), SYN["spk_embed_dim"],
                       SYN["gin_channels"], 48000]}
    model, cfg, _ = build_synthesizer(sd, meta, device="cpu")
    assert cfg.model.upsample_initial_channel == 32
    np.testing.assert_array_equal(model.emb_g.weight.detach().numpy(),
                                  np.asarray(params["emb_g"]["embedding"]))


# -- faiss --------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_faiss_index_reads_as_in_jax(tmp_path, kind):
    from rvc_tpu.utils import faiss_io as jf
    from rvc_tpu_torch.ops.retrieval import FeatureIndex
    from rvc_tpu_torch.utils import faiss_io

    vectors = np.random.default_rng(4).normal(size=(700, 24)).astype(np.float32)
    path = str(tmp_path / f"added_{kind}.index")
    if kind == "flat":
        jf.write_index_flat(path, vectors)
    else:
        jf.write_index_ivf_flat(path, vectors, nlist=9)
    ref = jf.read_index_vectors(path)
    got = faiss_io.read_index_vectors(path)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, vectors)
    np.testing.assert_array_equal(FeatureIndex.load(path, device="cpu").vectors.numpy(),
                                  vectors)


def test_faiss_flat_writer_reads_in_jax(tmp_path):
    from rvc_tpu.utils import faiss_io as jf
    from rvc_tpu_torch.utils import faiss_io

    vectors = np.random.default_rng(5).normal(size=(33, 8)).astype(np.float32)
    path = str(tmp_path / "flat.index")
    faiss_io.write_index_flat(path, vectors)
    np.testing.assert_array_equal(jf.read_index_vectors(path), vectors)


@pytest.mark.parametrize("damage", ["truncated", "fourcc", "ivf_truncated"])
def test_faiss_bad_files_raise(tmp_path, damage):
    from rvc_tpu.utils import faiss_io as jf
    from rvc_tpu_torch.utils import faiss_io

    vectors = np.random.default_rng(6).normal(size=(100, 8)).astype(np.float32)
    path = str(tmp_path / "x.index")
    if damage == "ivf_truncated":
        jf.write_index_ivf_flat(path, vectors, nlist=4)
    else:
        faiss_io.write_index_flat(path, vectors)
    raw = open(path, "rb").read()
    raw = b"IxQ9" + raw[4:] if damage == "fourcc" else raw[:len(raw) - 50]
    open(path, "wb").write(raw)
    for reader in (jf.read_index_vectors, faiss_io.read_index_vectors):
        with pytest.raises(ValueError):
            reader(path)


# -- embedder -----------------------------------------------------------------

def _hf_state_dict(params, spelling):
    """The port's HuBERT state_dict rewritten in the HF layout: the
    positional conv's weight norm over dim 2 (g [1, 1, K]), in one of the
    two key spellings, and HF's unused ``masked_spec_embed``."""
    from rvc_tpu_torch.models.commons import weight_norm

    sd = convert.hubert_state_dict(params)
    base = "encoder.pos_conv_embed.conv"
    w = weight_norm(sd.pop(f"{base}.weight_v"), sd.pop(f"{base}.weight_g"))
    g = torch.sqrt(torch.sum(w * w, dim=(0, 1), keepdim=True))
    if spelling == "weight_g":
        sd[f"{base}.weight_g"], sd[f"{base}.weight_v"] = g, w
    else:
        sd[f"{base}.parametrizations.weight.original0"] = g
        sd[f"{base}.parametrizations.weight.original1"] = w
    sd["masked_spec_embed"] = torch.zeros(HUB["hidden_size"])
    return sd


def _write_safetensors(path, sd):
    header, blobs, off = {}, [], 0
    for k, v in sd.items():
        raw = v.numpy().astype("<f4").tobytes()
        header[k] = {"dtype": "F32", "shape": list(v.shape),
                     "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))


@pytest.mark.parametrize("fmt,spelling,proj", [
    ("bin", "weight_g", None), ("safetensors", "parametrizations", None),
    ("bin", "parametrizations", 16)])
def test_embedder_loads_as_in_jax(tmp_path, fmt, spelling, proj):
    from rvc_tpu.embedders.hubert import FlaxHubert
    from rvc_tpu.embedders.hubert import HubertConfig as FHC
    from rvc_tpu.embedders.hubert import load_embedder as jax_load
    from rvc_tpu_torch.embedders.hubert import HubertConfig, load_embedder

    fhub = FlaxHubert(FHC(final_proj_dim=proj, **HUB))
    params = _random_params(fhub.init, jax.random.PRNGKey(0), jnp.zeros((1, 3200)),
                            seed=41)["params"]
    sd = _hf_state_dict(params, spelling)
    path = str(tmp_path / f"pytorch_model.{fmt}")
    if fmt == "bin":
        torch.save(sd, path)
    else:
        _write_safetensors(path, sd)
    jmod, jparams = jax_load(path, FHC(final_proj_dim=proj, **HUB))
    hub = load_embedder(path, HubertConfig(final_proj_dim=proj, **HUB), device="cpu")
    audio = (0.3 * np.random.default_rng(8).normal(size=(1, 8000))).astype(np.float32)
    ref = np.asarray(jmod.apply({"params": jparams}, jnp.asarray(audio)))
    out = hub(torch.from_numpy(audio)).numpy()
    assert out.shape == ref.shape == (1, 24, proj or HUB["hidden_size"])
    assert _rel(ref, out) <= 1e-4


def test_embedder_registry_falls_back_to_random(tmp_path, monkeypatch, capsys):
    from rvc_tpu_torch.embedders.hubert import (HubertConfig, load_embedder_by_name,
                                                resolve_embedder_path)

    monkeypatch.chdir(tmp_path)
    assert resolve_embedder_path("contentvec") is None
    with pytest.raises(ValueError, match="unknown embedder"):
        resolve_embedder_path("nope")
    hub = load_embedder_by_name("contentvec", cfg=HubertConfig(**HUB), device="cpu")
    assert "random-initialized" in capsys.readouterr().out
    assert hub.final_proj is None
    (tmp_path / "models" / "embedders" / "spin").mkdir(parents=True)
    torch.save({}, str(tmp_path / "models" / "embedders" / "spin" / "model.pt"))
    assert resolve_embedder_path("spin").endswith("spin/model.pt")


# -- RMVPE --------------------------------------------------------------------

def _reference_rmvpe_state_dict(seed=0):
    """A random state_dict in the reference ``rmvpe.pt`` layout at the
    default widths: the port's E2EModel names with an ``nn.GRU`` and batch
    norms' ``num_batches_tracked``."""
    from rvc_tpu_torch.predictors.rmvpe import E2EModel

    rng = np.random.default_rng(seed)
    names = {k: tuple(v.shape) for k, v in E2EModel().state_dict().items()
             if not k.startswith("fc.0.gru.")}
    names.update({f"fc.0.gru.{k}": tuple(v.shape) for k, v in torch.nn.GRU(
        384, 256, batch_first=True, bidirectional=True).state_dict().items()})
    sd = {}
    for k, shape in names.items():
        if k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, size=shape).astype(np.float32))
        else:
            sd[k] = torch.from_numpy((0.1 * rng.normal(size=shape)).astype(np.float32))
        if k.endswith("running_mean"):
            sd[k[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(7)
    return sd


def test_rmvpe_checkpoint_converts_as_in_jax(tmp_path):
    from rvc_tpu.predictors.rmvpe import convert_torch_rmvpe
    from rvc_tpu_torch.predictors.rmvpe import RMVPE, state_dict_from_torch_rmvpe

    sd = _reference_rmvpe_state_dict()
    ref = convert.rmvpe_state_dict(*convert_torch_rmvpe(sd))
    got = state_dict_from_torch_rmvpe(sd)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy(), err_msg=k)
    path = str(tmp_path / "rmvpe.pt")
    torch.save(sd, path)
    model = RMVPE.from_torch_checkpoint(path, device="cpu").model
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k].numpy(), err_msg=k)


def test_rmvpe_infer_from_audio_matches_jax():
    """A length that is not a whole second: reflect-padded to the 1 s
    bucket in both packages, the true frame count sliced after."""
    from rvc_tpu.predictors.rmvpe import RMVPE as JaxRMVPE
    from rvc_tpu.predictors.rmvpe import E2EModel as FlaxE2E
    from rvc_tpu_torch.predictors.rmvpe import RMVPE, E2EModel

    fe2e = FlaxE2E(**E2E)
    ev = _random_params(fe2e.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 128)),
                        seed=13)
    stats = _fix_var(ev["batch_stats"])
    e2e = E2EModel(**E2E)
    convert.load_into(e2e, convert.rmvpe_state_dict(ev["params"], stats))
    tt = np.arange(21700) / 16000
    audio = (0.4 * np.sin(2 * np.pi * 180 * tt)
             + 0.05 * np.random.default_rng(9).normal(size=tt.size)).astype(np.float32)
    ref = JaxRMVPE(ev["params"], stats, model=fe2e).infer_from_audio(audio)
    out = RMVPE(e2e, device="cpu").infer_from_audio(audio)
    assert out.shape == ref.shape == (21700 // 160 + 1,)
    assert (ref > 0).any()
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-3)


def test_plain_weights_fold_into_weight_norm(tmp_path):
    """A weight-normalized module stored as a plain ``weight`` (weight norm
    removed before saving) loads with that weight as its effective one."""
    from rvc_tpu_torch.models.synthesizer import Synthesizer
    from rvc_tpu_torch.utils.checkpoints import build_synthesizer, load_rvc_pth

    _, params = _flax_synth(True, seed=8)
    path = tmp_path / "model.pth"
    _write_pth(path, params, True, "weight_g")
    cpt = torch.load(str(path), weights_only=True)
    ref = Synthesizer(flow_layers=2, **SYN)
    sd = {k: v.float() for k, v in cpt["weight"].items()}
    ref.load_state_dict(sd)
    want = _effective(ref)
    for base in ("dec.ups.0", "dec.resblocks.3.convs1.1", "flow.flows.2.enc.in_layers.0"):
        g, v = cpt["weight"].pop(f"{base}.weight_g"), cpt["weight"].pop(f"{base}.weight_v")
        cpt["weight"][f"{base}.weight"] = want[f"{base}.weight"].half()
    torch.save(cpt, str(path))
    model, _, _ = build_synthesizer(*load_rvc_pth(str(path)), device="cpu")
    got = _effective(model)
    for base in ("dec.ups.0", "dec.resblocks.3.convs1.1", "flow.flows.2.enc.in_layers.0"):
        k = f"{base}.weight"
        np.testing.assert_allclose(got[k].numpy(), want[k].half().float().numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
