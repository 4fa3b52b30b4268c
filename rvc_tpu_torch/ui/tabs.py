"""UI tab builders (port of ``rvc_tpu/ui/tabs.py``).

The reference's tabs/inference/inference.py:356+ (single and batch
conversion with the whole effect-knob surface, preset import and export,
index auto-match), tabs/train/train.py:297 (preprocess, extract, train,
index, with pretrained pickers), tabs/tts/tts.py (the voice list), the
voice blender, download (a link and a zip drop), utilities (analyzer and
f0 extractor) and settings (theme, language, precision, restart). Each
builder takes ``(gr, i18n)`` as JAX's, so that the gradio import stays in
``app.build_app`` and the tests drive the builders through a fake ``gr``;
those that run models take ``device`` too (the card by default), and the
inference and TTS tabs convert at the precision of the settings. The
callbacks call the port's library functions, as the CLI does.
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time


def _model_choices():
    cands = sorted(
        glob.glob(os.path.join("logs", "**", "*.npz"), recursive=True)
        + glob.glob(os.path.join("logs", "**", "*.pth"), recursive=True)
    )
    # keep synthesizer checkpoints only: drop retrieval indexes and
    # discriminator checkpoints that share the logs/ tree
    return [
        p for p in cands
        if not p.endswith(".index.npz")
        and not os.path.basename(p).startswith("D_")
    ]


def _index_choices():
    return sorted(
        glob.glob(os.path.join("logs", "**", "*.index.npz"), recursive=True)
        + glob.glob(os.path.join("logs", "**", "*.index"), recursive=True)
    )


def _match_index(model_path: str) -> str:
    """Auto-pick the index living next to a model (reference
    tabs/inference/inference.py match_index). Native .index.npz preferred,
    migrated faiss .index accepted."""
    if not model_path:
        return ""
    exp_dir = os.path.dirname(model_path)
    cands = (sorted(glob.glob(os.path.join(exp_dir, "*.index.npz")))
             or sorted(glob.glob(os.path.join(exp_dir, "*.index"))))
    return cands[0] if cands else ""


def _pretrained_choices(prefix: str):
    # staged defaults are named f0G{sr}k/f0D{sr}k (downloads.py), custom
    # drops may be plain G*/D* — match both
    pats = []
    for stem in (prefix, f"f0{prefix}"):
        pats += [os.path.join("models", "pretraineds", "**", f"{stem}*.npz"),
                 os.path.join("models", "pretraineds", "**", f"{stem}*.pth")]
    out = set()
    for p in pats:
        out.update(glob.glob(p, recursive=True))
    return sorted(out)


# knob order shared by the single/batch converters and the preset bundlers
_KNOBS = (
    "pitch", "filter_radius", "index_rate", "volume_envelope", "protect",
    "f0_method", "split_audio", "f0_autotune", "f0_autotune_strength",
    "clean_audio", "clean_strength", "export_format", "embedder_model",
    "formant_shifting", "formant_qfrency", "formant_timbre",
    "post_process", "reverb", "pitch_shift", "limiter", "gain", "distortion",
    "chorus", "bitcrush", "clipping", "compressor", "delay",
    "reverb_room_size", "reverb_damping", "reverb_wet_gain",
    "reverb_dry_gain", "reverb_width", "reverb_freeze_mode",
    "pitch_shift_semitones", "limiter_threshold", "limiter_release_time",
    "gain_db", "distortion_gain", "chorus_rate", "chorus_depth",
    "chorus_center_delay", "chorus_feedback", "chorus_mix",
    "bitcrush_bit_depth", "clipping_threshold", "compressor_threshold",
    "compressor_ratio", "compressor_attack", "compressor_release",
    "delay_seconds", "delay_feedback", "delay_mix",
)


# per-knob help text (i18n keys); surfaced as the component `info` line like
# the reference's tabs/inference/inference.py tooltip strings
_KNOB_INFO = {
    "pitch": "Transpose the output voice in semitones; +12 is one octave up.",
    "filter_radius": "Median-filter the pitch contour; 3 or higher smooths "
                     "out octave flickers, values below 1 act as the FCPE "
                     "confidence threshold.",
    "index_rate": "How strongly retrieved training-set timbre replaces the "
                  "converted features; higher values sound more like the "
                  "training voice but can leak its accent and noise.",
    "volume_envelope": "Blend between the input loudness contour and the "
                       "synthesized one; 1 keeps the model output untouched.",
    "protect": "Shield breaths and unvoiced consonants from timbre "
               "replacement; lower values protect more, 0.5 disables the "
               "guard.",
    "f0_method": "Pitch tracker used for conversion; rmvpe is the most "
                 "robust, hybrids take the median of several trackers.",
    "split_audio": "Cut the input at silences and convert the pieces "
                   "separately; helps very long or noisy recordings.",
    "f0_autotune": "Snap the detected pitch to the closest semitone before "
                   "conversion.",
    "f0_autotune_strength": "How far each frame is pulled toward the snapped "
                            "note; 1 is a hard snap.",
    "clean_audio": "Denoise the input before conversion; meant for speech "
                   "recordings, not music.",
    "clean_strength": "Aggressiveness of the denoiser; too high can dull "
                      "the voice.",
    "export_format": "Container used when saving the converted audio.",
    "embedder_model": "Speech representation model that extracts content "
                      "features from the input.",
    "formant_shifting": "Shift formants to nudge the voice character "
                        "between deeper and brighter; useful for male/female "
                        "conversions.",
    "formant_qfrency": "Quefrency scale of the formant shift; higher moves "
                       "formants further.",
    "formant_timbre": "Timbre scale of the formant shift; interacts with "
                      "quefrency.",
    "post_process": "Run the selected studio effects on the converted audio "
                    "before export.",
    "reverb": "Add room reverberation to the output.",
    "pitch_shift": "Shift the output pitch as an audio effect, after "
                   "conversion.",
    "limiter": "Stop peaks from exceeding the threshold.",
    "gain": "Apply a flat gain to the output.",
    "distortion": "Add harmonic distortion drive.",
    "chorus": "Thicken the voice with modulated delayed copies.",
    "bitcrush": "Reduce bit depth for a lo-fi texture.",
    "clipping": "Hard-clip samples above the threshold.",
    "compressor": "Even out the dynamic range.",
    "delay": "Add an echo tap.",
    "reverb_room_size": "Simulated room size; larger rooms decay longer.",
    "reverb_damping": "High-frequency absorption of the reverb tail.",
    "reverb_wet_gain": "Level of the reverberated signal.",
    "reverb_dry_gain": "Level of the untouched signal.",
    "reverb_width": "Stereo width of the reverb.",
    "reverb_freeze_mode": "Hold the reverb tail indefinitely at 1.",
    "pitch_shift_semitones": "Effect pitch shift amount in semitones.",
    "limiter_threshold": "Ceiling in dB the limiter enforces.",
    "limiter_release_time": "How quickly the limiter recovers, in seconds.",
    "gain_db": "Gain amount in dB.",
    "distortion_gain": "Drive of the distortion in dB.",
    "chorus_rate": "Modulation speed of the chorus in Hz.",
    "chorus_depth": "Modulation depth of the chorus.",
    "chorus_center_delay": "Base delay of the chorus voices in ms.",
    "chorus_feedback": "How much chorus output feeds back into itself.",
    "chorus_mix": "Balance between dry and chorused signal.",
    "bitcrush_bit_depth": "Bits kept per sample; fewer bits, harsher sound.",
    "clipping_threshold": "Level in dB where samples clip.",
    "compressor_threshold": "Level in dB where compression starts.",
    "compressor_ratio": "Compression slope above the threshold.",
    "compressor_attack": "How fast compression engages, in ms.",
    "compressor_release": "How fast compression releases, in ms.",
    "delay_seconds": "Echo spacing in seconds.",
    "delay_feedback": "How much echo output feeds back for repeats.",
    "delay_mix": "Balance between dry signal and echo.",
}


def _build_knobs(gr, i18n):
    """The full conversion/effect control surface (reference exposes 40+
    knobs, tabs/inference/inference.py:356+). Returns {name: component} in
    _KNOBS order."""
    def inf(name):
        return i18n(_KNOB_INFO[name]) if name in _KNOB_INFO else None

    k = {}
    k["pitch"] = gr.Slider(-24, 24, 0, step=1, label=i18n("Pitch"),
                           info=inf("pitch"))
    k["filter_radius"] = gr.Slider(
        0, 10, 3, step=1, label=i18n("Filter Radius"),
        info=inf("filter_radius"))
    k["index_rate"] = gr.Slider(0, 1, 0.3, label=i18n("Search Feature Ratio"),
                                info=inf("index_rate"))
    k["volume_envelope"] = gr.Slider(0, 1, 1.0, label=i18n("Volume Envelope"),
                                     info=inf("volume_envelope"))
    k["protect"] = gr.Slider(
        0, 0.5, 0.33, label=i18n("Protect Voiceless Consonants"),
        info=inf("protect"))
    k["f0_method"] = gr.Radio(
        ["rmvpe", "fcpe", "crepe", "crepe-tiny", "yin",
         "hybrid[crepe+rmvpe]", "hybrid[crepe+fcpe]", "hybrid[rmvpe+fcpe]",
         "hybrid[crepe+rmvpe+fcpe]"],
        value="rmvpe", label=i18n("Pitch extraction algorithm"),
        info=inf("f0_method"))
    k["split_audio"] = gr.Checkbox(False, label=i18n("Split Audio"),
                                   info=inf("split_audio"))
    k["f0_autotune"] = gr.Checkbox(False, label=i18n("Autotune"),
                                   info=inf("f0_autotune"))
    k["f0_autotune_strength"] = gr.Slider(
        0, 1, 1.0, label=i18n("Autotune Strength"),
        info=inf("f0_autotune_strength"))
    k["clean_audio"] = gr.Checkbox(False, label=i18n("Clean Audio"),
                                   info=inf("clean_audio"))
    k["clean_strength"] = gr.Slider(0, 1, 0.7, label=i18n("Clean Strength"),
                                    info=inf("clean_strength"))
    k["export_format"] = gr.Radio(
        ["WAV", "MP3", "FLAC", "OGG", "M4A"], value="WAV",
        label=i18n("Export Format"), info=inf("export_format"))
    k["embedder_model"] = gr.Radio(
        ["contentvec", "spin", "chinese-hubert-base", "japanese-hubert-base",
         "korean-hubert-base", "custom"],
        value="contentvec", label=i18n("Embedder Model"),
        info=inf("embedder_model"))
    k["formant_shifting"] = gr.Checkbox(
        False, label=i18n("Formant Shifting"), info=inf("formant_shifting"))
    k["formant_qfrency"] = gr.Slider(
        0.0, 16.0, 1.0, label=i18n("Quefrency for formant shifting"),
        info=inf("formant_qfrency"))
    k["formant_timbre"] = gr.Slider(
        0.0, 16.0, 1.0, label=i18n("Timbre for formant shifting"),
        info=inf("formant_timbre"))
    k["post_process"] = gr.Checkbox(False, label=i18n("Post-Process"),
                                    info=inf("post_process"))
    for fx in ("reverb", "pitch_shift", "limiter", "gain", "distortion",
               "chorus", "bitcrush", "clipping", "compressor", "delay"):
        k[fx] = gr.Checkbox(False, label=i18n(fx.replace("_", " ").title()),
                            info=inf(fx))
    for name, lo, hi, default in (
        ("reverb_room_size", 0.0, 1.0, 0.5),
        ("reverb_damping", 0.0, 1.0, 0.5),
        ("reverb_wet_gain", 0.0, 1.0, 0.33),
        ("reverb_dry_gain", 0.0, 1.0, 0.4),
        ("reverb_width", 0.0, 1.0, 1.0),
        ("reverb_freeze_mode", 0.0, 1.0, 0.0),
        ("pitch_shift_semitones", -12.0, 12.0, 0.0),
        ("limiter_threshold", -60.0, 0.0, -6.0),
        ("limiter_release_time", 0.01, 1.0, 0.01),  # CLI/reference default
        ("gain_db", -60.0, 60.0, 0.0),
        ("distortion_gain", 0.0, 60.0, 25.0),
        ("chorus_rate", 0.1, 10.0, 1.0),
        ("chorus_depth", 0.0, 1.0, 0.25),
        ("chorus_center_delay", 0.0, 50.0, 7.0),
        ("chorus_feedback", 0.0, 1.0, 0.0),
        ("chorus_mix", 0.0, 1.0, 0.5),
        ("bitcrush_bit_depth", 1, 32, 8),
        ("clipping_threshold", -60.0, 0.0, -6.0),
        ("compressor_threshold", -60.0, 0.0, 0.0),
        ("compressor_ratio", 1.0, 20.0, 1.0),
        ("compressor_attack", 0.1, 100.0, 1.0),
        ("compressor_release", 10.0, 1000.0, 100.0),
        ("delay_seconds", 0.0, 5.0, 0.5),
        ("delay_feedback", 0.0, 1.0, 0.0),
        ("delay_mix", 0.0, 1.0, 0.5),
    ):
        step = 1 if name == "bitcrush_bit_depth" else None
        k[name] = gr.Slider(lo, hi, default, step=step,
                            label=i18n(name.replace("_", " ").title()),
                            info=inf(name))
    return k


def _knob_kwargs(values) -> dict:
    return dict(zip(_KNOBS, values))


def _converter(device):
    from ..infer.converter import VoiceConverter

    return VoiceConverter(precision=load_ui_config().get("precision", "bf16"),
                          device=device)


def inference_tab(gr, i18n, device="cuda"):
    from ..utils.presets import list_presets, load_preset, save_preset

    vc = _converter(device)

    with gr.Row():
        model = gr.Dropdown(
            label=i18n("Voice Model"), choices=_model_choices(),
            info=i18n("Trained voice checkpoint to convert with."))
        index = gr.Dropdown(
            label=i18n("Index File"), choices=_index_choices(),
            info=i18n("Retrieval index built from the training set; "
                      "auto-matched when you pick a model."))
        refresh = gr.Button(i18n("Refresh"))
    sid = gr.Slider(
        0, 108, 0, step=1, label=i18n("Speaker ID"),
        info=i18n("Speaker slot inside multi-speaker models; leave 0 "
                  "for single-voice models."))
    embedder_custom = gr.Textbox(
        label=i18n("Custom Embedder"), value="", visible=True,
        info=i18n("Path to a custom content-embedder checkpoint; used "
                  "when the embedder choice is 'custom'."))
    f0_file = gr.Textbox(
        label=i18n("F0 File Path"), value="",
        info=i18n("Optional external pitch contour (rows of time and "
                  "Hz) that overrides the tracker."))

    # index auto-match when a model is picked (reference match_index)
    model.change(lambda m: gr.update(value=_match_index(m)), [model], [index])

    with gr.Tab(i18n("Single")):
        audio_in = gr.Audio(label=i18n("Upload Audio"), type="filepath")
        with gr.Row():
            preset = gr.Dropdown(
                label=i18n("Preset"), choices=list_presets(),
                info=i18n("Saved bundle of conversion settings."))
            apply_preset = gr.Button(i18n("Apply Preset"))
            preset_name = gr.Textbox(
                label=i18n("Preset Name"), value="",
                info=i18n("Name under which the current settings are "
                          "exported."))
            export_preset = gr.Button(i18n("Export Preset"))
        with gr.Accordion(i18n("Advanced Settings"), open=False):
            knobs = _build_knobs(gr, i18n)
        knob_list = [knobs[n] for n in _KNOBS]

        def do_apply_preset(name, *values):
            if not name:
                return list(values)
            pr = load_preset(name)
            return [pr.get(k, v) for k, v in zip(_KNOBS, values)]

        apply_preset.click(do_apply_preset, [preset] + knob_list, knob_list)

        def do_export_preset(name, *values):
            if not name:
                return i18n("A preset name is required.")
            path = save_preset(name, _knob_kwargs(values))
            return i18n("Preset saved to") + f" {path}"

        status_preset = gr.Textbox(label=i18n("Output Information"))
        export_preset.click(do_export_preset, [preset_name] + knob_list,
                            [status_preset])

        convert_btn = gr.Button(i18n("Convert"))
        audio_out = gr.Audio(label=i18n("Export Audio"))

        def do_convert(path, mdl, idx, spk, emb_custom, f0f, *values):
            kw = _knob_kwargs(values)
            # per-invocation output name: a fixed path would let concurrent
            # or successive conversions clobber each other while gradio is
            # still serving the previous file
            base = os.path.splitext(os.path.basename(path or "audio"))[0]
            out = os.path.join(
                "logs", f"{base}_output_{int(time.time() * 1000)}.wav")
            result = vc.convert_audio(
                audio_input_path=path, audio_output_path=out, model_path=mdl,
                index_path=idx or "", sid=int(spk),
                embedder_model_custom=emb_custom or None,
                f0_file=f0f or None, **kw,
            )
            return result

        convert_btn.click(
            do_convert,
            [audio_in, model, index, sid, embedder_custom, f0_file] + knob_list,
            [audio_out],
        )

    with gr.Tab(i18n("Batch")):
        in_folder = gr.Textbox(
            label=i18n("Input Folder"),
            info=i18n("Folder of audio files to convert in bulk."))
        out_folder = gr.Textbox(
            label=i18n("Output Folder"),
            info=i18n("Folder the converted files are written to."))
        with gr.Accordion(i18n("Advanced Settings"), open=False):
            bknobs = _build_knobs(gr, i18n)
        bknob_list = [bknobs[n] for n in _KNOBS]
        batch_btn = gr.Button(i18n("Convert"))
        status = gr.Textbox(label=i18n("Output Information"))

        def do_batch(inf, outf, mdl, idx, spk, emb_custom, *values):
            kw = _knob_kwargs(values)
            vc.convert_audio_batch(
                audio_input_paths=inf, audio_output_path=outf,
                model_path=mdl, index_path=idx or "", sid=int(spk),
                embedder_model_custom=emb_custom or None, **kw,
            )
            return i18n("Batch conversion complete; results in") + f" {outf}"

        batch_btn.click(
            do_batch,
            [in_folder, out_folder, model, index, sid, embedder_custom]
            + bknob_list,
            [status],
        )

    refresh.click(
        lambda: (gr.update(choices=_model_choices()),
                 gr.update(choices=_index_choices())),
        [], [model, index],
    )


_TRAIN_THREAD = {"thread": None, "error": None}


def train_tab(gr, i18n, device="cuda"):
    model_name = gr.Textbox(
        label=i18n("Model Name"), value="my-voice",
        info=i18n("Experiment name; checkpoints and logs are written "
                  "under logs/<name>."))
    sample_rate = gr.Radio(
        [32000, 40000, 48000], value=48000, label=i18n("Sample Rate"),
        info=i18n("Rate the model synthesizes at; pick the one matching "
                  "your dataset quality."))
    vocoder = gr.Radio(
        ["HiFi-GAN", "MRF HiFi-GAN", "RefineGAN"],
        value="HiFi-GAN", label=i18n("Vocoder"),
        info=i18n("Waveform decoder architecture; HiFi-GAN is the "
                  "pretrained default, the others need matching "
                  "pretrains."))

    with gr.Accordion(i18n("Preprocess")):
        dataset = gr.Textbox(
            label=i18n("Dataset Path"),
            info=i18n("Folder with your training recordings."))
        cut_mode = gr.Radio(
            ["Skip", "Simple", "Automatic"], value="Automatic",
            label=i18n("Audio cutting"),
            info=i18n("How recordings are sliced: Automatic cuts at "
                      "silences, Simple cuts fixed windows, Skip keeps "
                      "files whole."))
        process_effects = gr.Checkbox(
            True, label=i18n("Process effects"),
            info=i18n("Run the filtering/normalization chain while "
                      "slicing; turn off for already-processed "
                      "datasets."))
        noise_reduction = gr.Checkbox(
            False, label=i18n("Noise Reduction"),
            info=i18n("Denoise each slice before it enters the "
                      "dataset."))
        nr_strength = gr.Slider(
            0, 1, 0.7, label=i18n("Noise Reduction Strength"),
            info=i18n("Aggressiveness of the dataset denoiser."))
        pre_btn = gr.Button(i18n("Preprocess Dataset"))
        pre_out = gr.Textbox(label=i18n("Output Information"))

        def do_pre(name, ds, sr, cm, fx, nr, nrs):
            from ..train.preprocess import preprocess_training_set

            hours = preprocess_training_set(
                ds, int(sr), os.path.join("logs", name), cut_preprocess=cm,
                process_effects=fx, noise_reduction=nr,
                reduction_strength=nrs,
            )
            return i18n("Preprocessed") + f" {hours:.2f} h"

        pre_btn.click(do_pre, [model_name, dataset, sample_rate, cut_mode,
                               process_effects, noise_reduction, nr_strength],
                      [pre_out])

    with gr.Accordion(i18n("Extract")):
        f0_method = gr.Radio(
            ["rmvpe", "fcpe", "crepe", "crepe-tiny", "yin"], value="rmvpe",
            label=i18n("Pitch extraction algorithm"),
            info=i18n("Tracker used to label the dataset pitch; rmvpe "
                      "is the most robust."))
        embedder = gr.Radio(
            ["contentvec", "spin", "chinese-hubert-base",
             "japanese-hubert-base", "korean-hubert-base", "custom"],
            value="contentvec", label=i18n("Embedder Model"))
        include_mutes = gr.Slider(
            0, 10, 2, step=1, label=i18n("Silent training files"),
            info=i18n("Silent filler samples added per speaker so the "
                      "model stays stable on silence."))
        ext_btn = gr.Button(i18n("Extract Features"))
        ext_out = gr.Textbox(label=i18n("Output Information"))

        def do_ext(name, sr, f0m, emb, mutes):
            from ..train.extract import run_extraction

            run_extraction(os.path.join("logs", name), f0_method=f0m,
                           sample_rate=int(sr), embedder_model=emb,
                           include_mutes=int(mutes), device=device)
            return i18n("Feature extraction complete.")

        ext_btn.click(do_ext, [model_name, sample_rate, f0_method, embedder,
                               include_mutes], [ext_out])

    with gr.Accordion(i18n("Train")):
        epochs = gr.Slider(
            1, 1000, 200, step=1, label=i18n("Total Epoch"),
            info=i18n("Epochs to train in total; small datasets "
                      "overtrain past a few hundred."))
        batch = gr.Slider(
            1, 64, 8, step=1, label=i18n("Batch Size"),
            info=i18n("Clips per training step; raise it until device "
                      "memory runs out for best throughput."))
        save_every = gr.Slider(
            1, 100, 10, step=1, label=i18n("Save Every Epoch"),
            info=i18n("Checkpoint interval in epochs."))
        save_only_latest = gr.Checkbox(
            False, label=i18n("Save Only Latest"),
            info=i18n("Overwrite one rolling checkpoint instead of "
                      "keeping every save; big disk saver."))
        with gr.Row():
            pretrained = gr.Checkbox(
                True, label=i18n("Pretrained"),
                info=i18n("Start from the staged base model instead of "
                          "random weights; dramatically less data and "
                          "time needed."))
            custom_pretrained = gr.Checkbox(
                False, label=i18n("Custom Pretrained"),
                info=i18n("Use hand-picked generator/discriminator "
                          "checkpoints below instead of the defaults."))
        with gr.Row():
            g_pretrained = gr.Dropdown(
                label=i18n("Custom Pretrained G"),
                choices=[""] + _pretrained_choices("G"), value="")
            d_pretrained = gr.Dropdown(
                label=i18n("Custom Pretrained D"),
                choices=[""] + _pretrained_choices("D"), value="")
        optimizer = gr.Radio(
            ["AdamW", "RAdam", "Ranger21"], value="AdamW",
            label=i18n("Optimizer"),
            info=i18n("Weight-update rule; AdamW is the reference "
                      "default, Ranger21 adds gradient centralization "
                      "and lookahead."))
        with gr.Row():
            warmup = gr.Checkbox(
                False, label=i18n("Use warmup"),
                info=i18n("Ramp the learning rate up over the first "
                          "epochs."))
            warmup_epochs = gr.Slider(
                1, 100, 5, step=1, label=i18n("Warmup duration"),
                info=i18n("Epochs the warmup ramp lasts."))
        with gr.Row():
            multiscale = gr.Checkbox(
                True, label=i18n("Multi-scale mel loss"),
                info=i18n("Compare mels at several resolutions; sharper "
                          "highs at a small compute cost."))
            double_d = gr.Checkbox(
                False, label=i18n("Double D update"),
                info=i18n("Update the discriminator twice per generator "
                          "step; can stabilize adversarial training."))
            balancer = gr.Checkbox(
                False, label=i18n("Loss balancer"),
                info=i18n("Auto-weight the generator losses by learned "
                          "uncertainty instead of fixed coefficients."))
            checkpointing = gr.Checkbox(
                False, label=i18n("Checkpointing"),
                info=i18n("Recompute activations in the backward pass "
                          "to fit larger batches in memory."))
        discriminators = gr.Dropdown(
            ["mpd", "mpd_v1", "mrd", "msstft", "mssbcqt", "msd",
             "fregan_mpd", "mmsd"],
            value=["mpd"], multiselect=True,
            label=i18n("Discriminators"),
            info=i18n("Adversarial critics judging the generated audio; "
                      "combining several shapes different aspects of "
                      "quality."))
        train_btn = gr.Button(i18n("Start Training"))
        stop_btn = gr.Button(i18n("Stop Training"))
        idx_btn = gr.Button(i18n("Generate Index"))
        train_out = gr.Textbox(label=i18n("Output Information"))

        def do_train(name, sr, voc, ep, bs, se, sol, pre, cus, gp, dp, opt,
                     wu, wue, ms, dd, bal, ckpt, discs):
            from ..cli import main as cli_main

            args = [
                "train", "--model_name", name, "--sample_rate", str(int(sr)),
                "--vocoder", voc, "--total_epoch", str(int(ep)),
                "--batch_size", str(int(bs)), "--save_every_epoch",
                str(int(se)), "--save_only_latest", str(bool(sol)),
                "--pretrained", str(bool(pre)),
                "--optimizer", opt, "--use_warmup", str(bool(wu)),
                "--warmup_duration", str(int(wue)),
                "--use_multiscale_mel_loss", str(bool(ms)),
                "--double_d_update", str(bool(dd)),
                "--use_balancer", str(bool(bal)),
                "--checkpointing", str(bool(ckpt)),
                "--discriminators", ",".join(discs) if discs else "mpd",
                "--device", str(device),
            ]
            if cus and gp:
                args += ["--g_pretrained_path", gp]
            if cus and dp:
                args += ["--d_pretrained_path", dp]
            # one live run at a time: a second Start would clear the first
            # run's pending stop flag and interleave checkpoint writes
            prev = _TRAIN_THREAD["thread"]
            if prev is not None and prev.is_alive():
                return i18n("A training run is already in progress; stop "
                            "it and wait for it to finish first.")
            # run in a thread so the UI stays responsive (the reference
            # forks a subprocess, tabs/train/train.py run_train_script).
            # Clear any stale stop flag BEFORE the thread exists: fit()
            # deliberately never clears it, so a Stop pressed during the
            # minutes-long compile still lands (trainer.request_stop).
            from ..train.trainer import reset_stop

            reset_stop()

            def _run():
                # surface failures: a daemon thread's traceback only hits
                # the server console, which the UI user never sees — write
                # it where the Stop/status handlers can report it
                try:
                    cli_main(args)
                except Exception:
                    import traceback

                    err = traceback.format_exc()
                    _TRAIN_THREAD["error"] = err
                    try:
                        os.makedirs(os.path.join("logs", name), exist_ok=True)
                        with open(os.path.join(
                                "logs", name, "train_error.log"), "w") as f:
                            f.write(err)
                    except OSError:
                        pass

            _TRAIN_THREAD["error"] = None
            t = threading.Thread(target=_run, daemon=True)
            _TRAIN_THREAD["thread"] = t
            t.start()
            return (f"training started in the background; follow "
                    f"logs/{name}/metrics.jsonl (errors land in "
                    f"logs/{name}/train_error.log)")

        def do_stop():
            from ..train.trainer import request_stop

            # fit() runs in a worker thread where SIGINT handlers cannot be
            # installed; the trainer polls this flag at each epoch boundary
            t = _TRAIN_THREAD["thread"]
            if t is None or not t.is_alive():
                err = _TRAIN_THREAD.get("error")
                if err:
                    return f"last training run FAILED:\n{err[-2000:]}"
                return i18n("No training run is in progress.")
            request_stop()
            return i18n("Stop requested; a checkpoint will be written at "
                        "the epoch boundary.")

        def do_index(name):
            from ..train.index_builder import build_index

            return build_index(os.path.join("logs", name), device=device)

        export_btn = gr.Button(i18n("Export Model"))

        def do_export(name):
            """Pack the deployable artifacts into one zip (the reference's
            'upload to Google Drive' step, minus the egress: the zip is the
            portable bundle a user downloads/shares)."""
            import zipfile

            exp = os.path.join("logs", name)
            if not os.path.isdir(exp):
                return f"no experiment at {exp}"
            picks = sorted(
                f for f in os.listdir(exp)
                if (f.endswith((".index.npz", ".index", ".pth"))
                    or (f.endswith(".npz") and "e." not in f and
                        not f.startswith(("G_", "D_"))))
            )
            deploy = [f for f in os.listdir(exp)
                      if f.endswith("e.npz") or f.endswith("e.pth")]
            picks = sorted(set(picks + deploy))
            if not picks:
                return i18n("Nothing to export yet; train the model and "
                            "build the index first.")
            out = os.path.join(exp, f"{name}_export.zip")
            with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as z:
                for f in picks:
                    z.write(os.path.join(exp, f), arcname=f)
            return f"exported {out} ({len(picks)} file(s))"

        train_btn.click(
            do_train,
            [model_name, sample_rate, vocoder, epochs, batch, save_every,
             save_only_latest, pretrained, custom_pretrained, g_pretrained,
             d_pretrained, optimizer, warmup, warmup_epochs, multiscale,
             double_d, balancer, checkpointing, discriminators],
            [train_out])
        stop_btn.click(do_stop, [], [train_out])
        idx_btn.click(do_index, [model_name], [train_out])
        export_btn.click(do_export, [model_name], [train_out])


def tts_tab(gr, i18n, device="cuda"):
    from ..utils.tts import list_voices

    text = gr.Textbox(
        label=i18n("Text to Synthesize"), lines=3,
        info=i18n("Text spoken by the TTS voice before conversion."))
    voice = gr.Dropdown(
        label=i18n("TTS Voices"), choices=list_voices(),
        value="en-US-AriaNeural",
        info=i18n("Base synthetic narrator; its speech is then converted "
                  "to your voice model."))
    rate = gr.Slider(
        -100, 100, 0, step=1, label=i18n("TTS Speed"),
        info=i18n("Speaking-rate offset of the TTS narrator in "
                  "percent."))
    model = gr.Dropdown(
        label=i18n("Voice Model"), choices=_model_choices(),
        info=i18n("Trained voice checkpoint to convert with."))
    with gr.Accordion(i18n("Advanced Settings"), open=False):
        knobs = _build_knobs(gr, i18n)
    knob_list = [knobs[n] for n in _KNOBS]
    btn = gr.Button(i18n("Convert"))
    out = gr.Audio(label=i18n("Export Audio"))

    # one converter per tab: repeated TTS conversions reuse its loaded
    # models (as inference_tab's does)
    vc = _converter(device)

    def do_tts(t, v, r, mdl, *values):
        from ..utils.tts import run_tts

        tts_path = os.path.join("logs", "tts_raw.wav")
        out_path = os.path.join("logs", "tts_output.wav")
        run_tts(t, v, int(r), tts_path)
        vc.convert_audio(
            audio_input_path=tts_path, audio_output_path=out_path,
            model_path=mdl, **_knob_kwargs(values),
        )
        return out_path

    btn.click(do_tts, [text, voice, rate, model] + knob_list, [out])


def voice_blender_tab(gr, i18n):
    name = gr.Textbox(
        label=i18n("Model Name"), value="blend",
        info=i18n("Name given to the fused model."))
    a = gr.Dropdown(label=i18n("Drag and drop your model here"),
                    choices=_model_choices(),
                    info=i18n("First voice model to fuse."))
    b = gr.Dropdown(label=i18n("You can also use a custom path"),
                    choices=_model_choices(),
                    info=i18n("Second voice model to fuse."))
    ratio = gr.Slider(
        0, 1, 0.5, label=i18n("Blend Ratio"),
        info=i18n("Weight of the second model in the fusion; 0.5 mixes "
                  "both equally."))
    btn = gr.Button(i18n("Fusion"))
    out = gr.Textbox(label=i18n("Output Information"))

    def do_blend(n, pa, pb, r):
        from ..utils.model_tools import model_blender

        return model_blender(n, pa, pb, r)

    btn.click(do_blend, [name, a, b, ratio], [out])


def download_tab(gr, i18n):
    link = gr.Textbox(
        label=i18n("Model Link"),
        info=i18n("Direct URL, Google Drive share link, or HuggingFace "
                  "page of a zipped model."))
    btn = gr.Button(i18n("Download Model"))
    out = gr.Textbox(label=i18n("Output Information"))

    def do_download(l):
        from ..utils.downloads import model_download_pipeline

        try:
            return model_download_pipeline(l)
        except RuntimeError as e:
            return str(e)

    btn.click(do_download, [link], [out])

    drop = gr.File(
        label=i18n("Drop files"),
        info=i18n("Install a local .zip/.pth/.index model bundle."))
    drop_out = gr.Textbox(label=i18n("Output Information"))

    def do_install(f):
        from ..utils.downloads import install_model_archive

        if f is None:
            return i18n("No file was dropped.")
        path = f if isinstance(f, str) else getattr(f, "name", str(f))
        try:
            return i18n("Installed") + f" {install_model_archive(path)}"
        except Exception as e:
            return str(e)

    drop.upload(do_install, [drop], [drop_out])


def utilities_tab(gr, i18n, device="cuda"):
    with gr.Accordion(i18n("Audio Analyzer")):
        audio = gr.Audio(label=i18n("Upload Audio"), type="filepath")
        btn = gr.Button(i18n("Get information about the audio"))
        info = gr.JSON(label=i18n("Output Information"))
        plot = gr.Image(label=i18n("Plot"))

        def do_analyze(path):
            from ..utils.analyzer import analyze_audio

            stats, plot_path = analyze_audio(
                path, save_plot_path=os.path.join("logs", "analysis.png"),
                device=device)
            return stats, plot_path

        btn.click(do_analyze, [audio], [info, plot])

    with gr.Accordion(i18n("F0 Curve")):
        audio2 = gr.Audio(label=i18n("Upload Audio"), type="filepath")
        method = gr.Radio(["rmvpe", "fcpe", "yin"], value="rmvpe",
                          label=i18n("Pitch extraction algorithm"),
                          info=i18n("Tracker used to draw the pitch "
                                    "curve."))
        midi = gr.Checkbox(label=i18n("Also transcribe to MIDI"),
                           value=False,
                           info=i18n("Additionally write the detected "
                                     "melody as a .mid file."))
        btn2 = gr.Button(i18n("Extract F0 Curve"))
        plot2 = gr.Image(label=i18n("Plot"))
        midi_file = gr.File(label=i18n("MIDI transcription"))

        def do_f0(path, m, want_midi):
            from ..predictors.f0_extractor import F0Extractor

            ex = F0Extractor(path, method=m, device=device)
            f0 = ex.extract_f0()
            os.makedirs("logs", exist_ok=True)
            png = ex.plot_f0(f0=f0, save_path=os.path.join("logs", "f0.png"))
            midi_path = None
            if want_midi:
                midi_path = os.path.join("logs", "f0.mid")
                ex.to_midi(output_path=midi_path, f0=f0)
            return png, midi_path

        btn2.click(do_f0, [audio2, method, midi], [plot2, midi_file])

    with gr.Accordion(i18n("Model Information")):
        pth = gr.Dropdown(label=i18n("Voice Model"),
                          choices=_model_choices(),
                          info=i18n("Checkpoint whose metadata to inspect."))
        btn3 = gr.Button(i18n("Get model information"))
        info3 = gr.Textbox(label=i18n("Output Information"), lines=6)

        def do_info(path):
            import io
            from contextlib import redirect_stdout

            from ..utils.model_tools import model_information

            buf = io.StringIO()
            with redirect_stdout(buf):
                model_information(path)
            return buf.getvalue()

        btn3.click(do_info, [pth], [info3])


UI_CONFIG_PATH = os.path.join("logs", "ui_config.json")
THEMES = ["default", "soft", "monochrome", "glass", "base"]


def load_ui_config() -> dict:
    if os.path.exists(UI_CONFIG_PATH):
        try:
            with open(UI_CONFIG_PATH) as f:
                return json.load(f)
        except Exception:
            pass
    return {}


def settings_tab(gr, i18n):
    from .i18n import I18nAuto

    cfg = load_ui_config()
    lang = gr.Dropdown(
        label=i18n("Language"),
        choices=["auto"] + I18nAuto().available_languages(),
        value=cfg.get("language", "auto"),
        info=i18n("Interface language; auto follows the system "
                  "locale."),
    )
    theme = gr.Dropdown(label=i18n("Theme"), choices=THEMES,
                        value=cfg.get("theme", "default"),
                        info=i18n("Visual theme of the interface."))
    precision = gr.Radio(["bf16", "fp32"],
                         value=cfg.get("precision", "bf16"),
                         label=i18n("Precision"),
                         info=i18n("Serving arithmetic: bf16 is the fast "
                                   "production default, fp32 is for "
                                   "numeric comparisons."))
    author = gr.Textbox(label=i18n("Model Author"),
                        value=cfg.get("author", ""),
                        info=i18n("Name embedded into models you train "
                                  "or export."))
    out = gr.Textbox(label=i18n("Output Information"))
    save = gr.Button(i18n("Save Settings"))
    restart = gr.Button(i18n("Restart Applio"))

    def do_save(l, th, p, a):
        os.makedirs("logs", exist_ok=True)
        with open(UI_CONFIG_PATH, "w") as f:
            json.dump({"language": l, "theme": th, "precision": p,
                       "author": a}, f, indent=2)
        return (i18n("Settings saved; restart the UI to apply language "
                     "and theme changes.") + f" ({UI_CONFIG_PATH})")

    def do_restart():
        # re-exec via `-m rvc_tpu_torch.ui.app`: exec'ing app.py as a plain
        # script would die on its relative imports (reference restart_applio)
        import sys

        os.execv(sys.executable,
                 [sys.executable, "-m", "rvc_tpu_torch.ui.app"] + sys.argv[1:])

    save.click(do_save, [lang, theme, precision, author], [out])
    restart.click(do_restart, [], [])
