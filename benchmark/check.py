"""The comparison that decides ``correct`` for a serving cell.

For each compared request (a sample drawn from the seed, and the window's
longest) the plain reference in ``benchmark/reference`` works the
conversion out again, in float32 with TF32 off, from the same input audio,
the same seeded weights and index and the same request seed. The random
retrieval of a bf16 salience or feature near a tie would make an end-to-end
waveform comparison meaningless (one flipped pitch bin moves the phase of
every later sample). A comparison blind to phase does not separate bf16 from
the fp8 control either: the multi-resolution STFT magnitudes of the
reference's own conversion from the audio, even over the spans where the
two f0 tracks agree, read as high for some bf16 seeds as for fp8, as flipped
voicing, pitch bins and retrieved rows move them in both. So the reference
follows the program stage by stage:

- ``salience_vs_bf16``: RMVPE's salience (mel, DeepUnet, BiGRU, head)
  from the audio, its gap over the gap of the reference itself computed
  with bf16 rounding (``operand_precision("bf16")``): random weights make
  some seeds' DeepUnet twice as sensitive to rounding as others', and this
  ratio, unlike the raw gap, reads alike over seeds, so that the program's
  bf16 and the fp8 control stay apart;
- ``features_gap``: the HuBERT features from the audio;
- ``synth_inputs_gap``: the synthesizer's inputs rebuilt from the program's
  salience and features (decode, median filter, shift, quantisation, exact
  top-8 retrieval and blend, protect): the worst of the features' and the
  f0's relative gaps and the share of frames whose coarse pitch is off by
  more than one bin;
- ``output_gap``: the returned waveform against the reference synthesizer
  (prior, flow, decoder with its stage tails) run on the program's
  synthesizer inputs with the request's noise, trimmed and normalised;
  ``output_vs_bf16``: the same gap over the bf16 reference's, for a decoder
  whose raw gap swings from seed to seed (RefineGAN's).

Each gap is ``|program - reference| / |reference|`` over the request, the
worst request counts. A configuration file compares the numbers its
``limits`` name, each against its limit."""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from . import weights
from .reference import conversion, hubert, rmvpe, synth
from .reference.ops import operand_precision

def rel(a, b) -> float:
    """|a - b| / |b| over every element; inf where the shapes differ or a
    value is not finite."""
    a = torch.as_tensor(a).double().flatten()
    b = torch.as_tensor(b).double().flatten().to(a.device)
    if a.numel() != b.numel():
        return math.inf
    r = float((a - b).norm() / b.norm().clamp(min=1e-30))
    return r if math.isfinite(r) else math.inf


def synth_arch(config: dict) -> dict:
    return {**config["synthesizer"], **config["flow"]}


def _request_geometry(audio: np.ndarray):
    pad = conversion.padded(audio)
    buck = conversion.in_bucket(pad)
    return pad, buck, len(buck) // conversion.WINDOW


def reference_conversion(sd, index, config, mix, req, device, precision="fp32") -> dict:
    """One conversion by the reference, in the record layout the program's
    recorder keeps (the fp8 control's stand-in for the program)."""
    s = mix["settings"]
    pad, buck, frames = _request_geometry(req.audio)
    x = torch.from_numpy(buck)[None].to(device)
    with operand_precision(precision):
        sal = rmvpe.salience_of_audio(sd["rmvpe"], x, frames + 1, config["rmvpe"])
        feats = hubert.features(sd["hubert"], x, config["hubert"])
        phone, pitch, pitchf = conversion.synth_inputs(sal[0], feats[0], index, s, frames)
        plen = conversion.p_len(len(pad), len(buck))
        args = [phone[None], torch.tensor([plen], device=device), pitch[None],
                pitchf[None], torch.tensor([s["sid"]], device=device)]
        gen = torch.Generator(device=device).manual_seed(int(req.seed))
        audio = synth.infer(sd["synth"], *args, gen, synth_arch(config), config["sample_rate"])
    upp = math.prod(config["synthesizer"]["upsample_rates"])
    out = conversion.finish(audio[0, :plen * upp].cpu().numpy(), config["sample_rate"])
    return {"req": req, "rmvpe": sal, "hubert": feats, "synth_in": args, "out": out}


@torch.no_grad()
def gaps(sd, index, config, mix, record, device) -> Dict[str, float]:
    """The numbers that ``config``'s limits name, for one recorded
    conversion."""
    names = config["limits"]
    s = mix["settings"]
    req = record["req"]
    pad, buck, frames = _request_geometry(req.audio)
    x = torch.from_numpy(buck)[None].to(device)
    sal_prog = record["rmvpe"][0, :frames + 1].to(device).float()
    feats_prog = record["hubert"][0].to(device).float()
    out = {}
    sal_ref = rmvpe.salience_of_audio(sd["rmvpe"], x, frames + 1, config["rmvpe"])[0]
    with operand_precision("bf16"):
        sal_bf16 = rmvpe.salience_of_audio(sd["rmvpe"], x, frames + 1, config["rmvpe"])[0]
    out["salience_vs_bf16"] = rel(sal_prog, sal_ref) / max(rel(sal_bf16, sal_ref), 1e-12)
    out["features_gap"] = rel(feats_prog, hubert.features(sd["hubert"], x, config["hubert"])[0])
    phone, pitch, pitchf, lengths, sid = (
        t.to(device) for t in (record["synth_in"][i] for i in (0, 2, 3, 1, 4)))
    want_phone, want_pitch, want_pitchf = conversion.synth_inputs(
        sal_prog, feats_prog, index, s, frames)
    off = (pitch[0].long() - want_pitch).abs() > 1
    out["synth_inputs_gap"] = max(rel(phone[0], want_phone), rel(pitchf[0], want_pitchf),
                                  float(off.double().mean()))
    upp = math.prod(config["synthesizer"]["upsample_rates"])
    plen = conversion.p_len(len(pad), len(buck))

    def synthesized():
        gen = torch.Generator(device=device).manual_seed(int(req.seed))
        audio = synth.infer(sd["synth"], phone, lengths, pitch.long(), pitchf.float(),
                            sid.long(), gen, synth_arch(config), config["sample_rate"])
        return conversion.finish(audio[0, :plen * upp].cpu().numpy(), config["sample_rate"])

    want_out = synthesized()
    out["output_gap"] = rel(record["out"], want_out)
    if "output_vs_bf16" in names:
        with operand_precision("bf16"):
            bf16_out = synthesized()
        out["output_vs_bf16"] = out["output_gap"] / max(rel(bf16_out, want_out), 1e-12)
    return {n: out[n] for n in names}


def compare(config: dict, mix: dict, seed: int, kept: dict, shapes, device) -> dict:
    """Worst gaps over the kept records, each beside its limit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sd = weights.model_states(config, shapes, seed, device)
    index = weights.seeded_index(config["index"]["rows"], config["index"]["dim"], seed, device)
    worst = {n: 0.0 for n in config["limits"]}
    for i in sorted(kept):
        g = gaps(sd, index, config, mix, kept[i], device)
        worst = {n: max(worst[n], g[n]) for n in worst}
    return {"compared": len(kept),
            "gaps": {n: {"value": v, "limit": config["limits"][n]} for n, v in worst.items()}}
