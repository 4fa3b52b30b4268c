"""Command line of the port: the JAX CLI's offline subcommands (port of
``rvc_tpu/cli.py``), run on the card.

    python -m rvc_tpu_torch.cli infer --input_path in.wav --output_path out.wav \\
        --pth_path model.pth --index_path model.index [--device cuda] \\
        [--formant_shifting True --formant_timbre 1.2 --clean_audio True \\
         --post_process True --reverb True --pitch_shift True \\
         --pitch_shift_semitones 2 --export_format FLAC]
    python -m rvc_tpu_torch.cli batch_infer --input_folder in/ --output_folder out/ \\
        --pth_path model.pth
    python -m rvc_tpu_torch.cli preprocess --model_name m --dataset_path data/ \\
        --sample_rate 48000
    python -m rvc_tpu_torch.cli extract --model_name m --sample_rate 48000 \\
        [--f0_method rmvpe --batch_size 8]
    python -m rvc_tpu_torch.cli train --model_name m --sample_rate 48000 \\
        [--total_epoch 200 --batch_size 8 --save_every_epoch 10 \\
         --vocoder "MRF HiFi-GAN" --discriminators mpd,mrd ...]
    python -m rvc_tpu_torch.cli index --model_name m [--index_algorithm KMeans]
    python -m rvc_tpu_torch.cli model_information --pth_path model.pth
    python -m rvc_tpu_torch.cli model_blender --model_name mix \\
        --pth_path_1 a.pth --pth_path_2 b.pth [--ratio 0.5]
    python -m rvc_tpu_torch.cli tensorboard [--logdir logs --port 9000]
    python -m rvc_tpu_torch.cli audio_analyzer --input_path out.wav \\
        [--save_plot_path report.png --device cuda]
    python -m rvc_tpu_torch.cli tts --tts_text "hello" --tts_voice en-US-AriaNeural \\
        --output_tts_path tts.wav --output_rvc_path out.wav --pth_path model.pth
    python -m rvc_tpu_torch.cli download --model_link file:///path/model.zip
    python -m rvc_tpu_torch.cli prerequisites [--models True --exe True \\
        --prime_cache 1-10]

The dataset commands run from the directory that holds ``logs/`` and write
into ``logs/<model_name>/``: ``preprocess`` the sliced WAVs, ``extract``
the f0 and feature files with ``filelist.txt``, ``train`` its checkpoints
and, at its end, the index, as ``index`` does. ``infer`` and
``batch_infer`` serve every option of the JAX CLI: formant shifting, the
spectral gate (``--clean_audio``) and the ten-effect post-FX chain on the
card, and export to WAV, FLAC, or MP3 / OGG / M4A through ``ffmpeg`` when
it is on ``PATH``. ``model_blender`` writes ``logs/<model_name>.pth``. The
parser is the port's own copy of the JAX CLI's argument surface, flag for
flag, so that a command line written for it parses unchanged; ``--device``
(default ``cuda``) is added. ``train --gpu 0-1`` trains on those cards, one
process each (``parallel.launch``), with ``--batch_size`` the global batch
split evenly over them (as JAX's one-host mesh splits it; the reference's
was per card); with ``--device cpu`` it runs that many CPU processes.
Training's ``--use_orbax`` raises ``NotImplementedError``. ``batch_infer``
on a machine with several cards, and ``--device cuda`` without an index,
shards each device batch over them. ``tts`` speaks through edge-tts or,
without it, the offline synthesizer, then converts; ``download`` installs
a model from a path, a ``file://`` URL or a link; ``prerequisites`` fetches
the missing predictor and pretrained files, builds the native audio engine
(``--exe``) and, with ``--prime_cache``, the three kernel libraries. Every
vocoder (``--vocoder "HiFi-GAN" | "MRF
HiFi-GAN" | RefineGAN``) trains and converts, at 32, 40 and 48 kHz, and
``--discriminators`` takes any comma list of the JAX registry's names.
``main(argv)`` returns the exit code.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("true", "1", "yes")


POST_FX_FLAGS = ("post_process", "reverb", "pitch_shift", "limiter", "gain",
                 "distortion", "chorus", "bitcrush", "clipping", "compressor",
                 "delay")
POST_FX_VALUES = (
    ("reverb_room_size", 0.5), ("reverb_damping", 0.5),
    ("reverb_wet_gain", 0.33), ("reverb_dry_gain", 0.4),
    ("reverb_width", 1.0), ("reverb_freeze_mode", 0.0),
    ("pitch_shift_semitones", 0.0), ("limiter_threshold", -6.0),
    ("limiter_release_time", 0.01), ("gain_db", 0.0),
    ("distortion_gain", 25.0), ("chorus_rate", 1.0),
    ("chorus_depth", 0.25), ("chorus_center_delay", 7.0),
    ("chorus_feedback", 0.0), ("chorus_mix", 0.5),
    ("clipping_threshold", -6.0), ("compressor_threshold", 0.0),
    ("compressor_ratio", 1.0), ("compressor_attack", 1.0),
    ("compressor_release", 100.0), ("delay_seconds", 0.5),
    ("delay_feedback", 0.0), ("delay_mix", 0.5),
)
INFER_KEYS = (
    "pitch filter_radius hop_length index_rate volume_envelope protect "
    "f0_method split_audio f0_autotune f0_autotune_strength clean_audio "
    "clean_strength export_format f0_file sid embedder_model "
    "embedder_model_custom formant_shifting formant_qfrency formant_timbre "
    "bitcrush_bit_depth").split() + list(POST_FX_FLAGS) + [
        k for k, _ in POST_FX_VALUES]


def _add_infer_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--pitch", type=int, default=0)
    p.add_argument("--filter_radius", type=int, default=3)
    p.add_argument("--index_rate", type=float, default=0.3)
    p.add_argument("--volume_envelope", type=float, default=1.0)
    p.add_argument("--protect", type=float, default=0.33)
    p.add_argument("--hop_length", type=int, default=128)
    p.add_argument("--f0_method", type=str, default="rmvpe",
                   choices=["crepe", "crepe-tiny", "rmvpe", "fcpe", "yin",
                            "hybrid[crepe+rmvpe]", "hybrid[crepe+fcpe]",
                            "hybrid[rmvpe+fcpe]", "hybrid[crepe+rmvpe+fcpe]",
                            "hybrid[rmvpe+yin]"])
    p.add_argument("--pth_path", type=str, required=True)
    p.add_argument("--index_path", type=str, default="")
    p.add_argument("--split_audio", type=_bool, default=False)
    p.add_argument("--f0_autotune", type=_bool, default=False)
    p.add_argument("--f0_autotune_strength", type=float, default=1.0)
    p.add_argument("--clean_audio", type=_bool, default=False)
    p.add_argument("--clean_strength", type=float, default=0.7)
    p.add_argument("--export_format", type=str, default="WAV",
                   choices=["WAV", "MP3", "FLAC", "OGG", "M4A"])
    p.add_argument("--f0_file", type=str, default=None)
    p.add_argument("--embedder_model", type=str, default="contentvec",
                   choices=["contentvec", "spin", "chinese-hubert-base",
                            "japanese-hubert-base", "korean-hubert-base",
                            "custom"])
    p.add_argument("--embedder_model_custom", type=str, default=None)
    p.add_argument("--sid", type=int, default=0)
    p.add_argument("--formant_shifting", type=_bool, default=False)
    p.add_argument("--formant_qfrency", type=float, default=1.0)
    p.add_argument("--formant_timbre", type=float, default=1.0)
    p.add_argument("--precision", type=str, default="bf16",
                   choices=["bf16", "fp32"])
    for flag in POST_FX_FLAGS:
        p.add_argument(f"--{flag}", type=_bool, default=False)
    for flag, default in POST_FX_VALUES:
        p.add_argument(f"--{flag}", type=float, default=default)
    p.add_argument("--bitcrush_bit_depth", type=int, default=8)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to convert on (the card by default; "
                        "'cpu' runs the kernels' plain versions)")


def pretrained_selector(vocoder: str, sample_rate: int) -> tuple:
    """Default pretrained G/D for a vocoder and rate, where staged: under
    models/pretraineds/<vocoder-lower>/ and then models/pretraineds/, the
    pair f0{G,D}<sr/1000>k as .npz or .pth; ("", "") when absent (training
    then starts from the seed's weights, as the reference does)."""
    sr_tag = str(sample_rate)[:2]
    for base in (os.path.join("models", "pretraineds", vocoder.lower()),
                 os.path.join("models", "pretraineds")):
        for ext in (".npz", ".pth"):
            path_g = os.path.join(base, f"f0G{sr_tag}k{ext}")
            path_d = os.path.join(base, f"f0D{sr_tag}k{ext}")
            if os.path.exists(path_g) and os.path.exists(path_d):
                return path_g, path_d
    return "", ""


def cleanup_previous_run(exp_dir: str) -> int:
    """A fresh start (reference train.py:377-403): remove a previous
    attempt's checkpoints, index, metrics and event files; keep the dataset
    (filelist, features, wavs). Returns how many entries went."""
    import shutil

    removed = 0
    if not os.path.isdir(exp_dir):
        return 0
    for fn in os.listdir(exp_dir):
        if (fn.startswith(("G_", "D_", "orbax_", "reference_e"))
                or fn.endswith((".index.npz", ".index"))
                or fn in ("metrics.jsonl", "heartbeat.json", "train_error.log")
                or fn.startswith("events.out.tfevents")):
            path = os.path.join(exp_dir, fn)
            try:
                if os.path.isdir(path):
                    shutil.rmtree(path)
                else:
                    os.remove(path)
                removed += 1
            except OSError as e:
                print(f"cleanup: could not remove {path} ({e})")
    print(f"cleanup: removed {removed} previous-attempt artifact(s)")
    return removed


def _add_train_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model_name", type=str, required=True)
    p.add_argument("--sample_rate", type=int, required=True,
                   choices=[32000, 40000, 48000])
    p.add_argument("--vocoder", type=str, default="HiFi-GAN",
                   choices=["HiFi-GAN", "MRF HiFi-GAN", "RefineGAN"])
    p.add_argument("--total_epoch", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--save_every_epoch", type=int, default=10)
    p.add_argument("--save_only_latest", type=_bool, default=False)
    p.add_argument("--pretrained", type=_bool, default=True)
    p.add_argument("--g_pretrained_path", type=str, default="")
    p.add_argument("--d_pretrained_path", type=str, default="")
    p.add_argument("--optimizer", type=str, default="AdamW",
                   choices=["AdamW", "RAdam", "Ranger21"])
    p.add_argument("--use_warmup", type=_bool, default=False)
    p.add_argument("--warmup_duration", type=int, default=5)
    p.add_argument("--use_multiscale_mel_loss", type=_bool, default=True)
    p.add_argument("--double_d_update", type=_bool, default=False)
    p.add_argument("--use_balancer", type=_bool, default=False)
    p.add_argument("--use_wgan_gp_loss", type=_bool, default=False)
    p.add_argument("--bf16_run", type=_bool, default=True)
    p.add_argument("--checkpointing", type=_bool, default=False)
    p.add_argument("--use_orbax", type=_bool, default=False,
                   help="the JAX package's sharded checkpoints (not in the port)")
    p.add_argument("--discriminators", type=str, default="mpd",
                   help="comma list of mpd, mpd_v1, mpd_v2, mrd, msstft, "
                        "mssbcqt, msd, fregan_mpd, mmsd (several combine)")
    p.add_argument("--index_algorithm", type=str, default="Auto")
    p.add_argument("--cleanup", type=_bool, default=False,
                   help="remove previous-attempt checkpoints/index/metrics "
                        "before training (reference train.py:377-403)")
    p.add_argument("--cache_data_in_gpu", type=_bool, default=False,
                   help="keep the padded dataset resident on the card")
    p.add_argument("--use_checkpointing", dest="checkpointing", type=_bool,
                   default=argparse.SUPPRESS,
                   help="alias of --checkpointing (reference flag name)")
    p.add_argument("--custom_pretrained", type=_bool, default=False,
                   help="use --g_pretrained_path/--d_pretrained_path instead "
                        "of the staged defaults (reference core.py:530-539)")
    p.add_argument("--use_custom_lr", type=_bool, default=False)
    p.add_argument("--custom_lr_g", type=float, default=None)
    p.add_argument("--custom_lr_d", type=float, default=None)
    p.add_argument("--save_every_weights", type=_bool, default=True,
                   help="export the deployable weights file on every save "
                        "epoch (final epoch always exports)")
    p.add_argument("--gpu", type=str, default="",
                   help="dash-separated card indices: one process on each "
                        "(with --device cpu, that many CPU processes)")
    p.add_argument("--use_tf32", type=_bool, default=False,
                   help="TensorFloat-32 in float32 matmuls and convolutions")
    p.add_argument("--use_benchmark", type=_bool, default=True,
                   help="cudnn.benchmark: cuDNN picks its algorithms by timing")
    p.add_argument("--use_deterministic", type=_bool, default=False,
                   help="cudnn.deterministic and deterministic algorithms")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (the card by default; "
                        "'cpu' runs the kernels' plain versions)")


def _add_tts_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--tts_text", type=str, default=None,
                   help="text to speak (or use --input_path)")
    p.add_argument("--tts_voice", type=str, required=True)
    p.add_argument("--tts_rate", type=int, default=0)
    p.add_argument("--input_path", "--tts_file", dest="input_path", type=str,
                   default=None, help="a text file instead of --tts_text "
                                      "(reference name: --tts_file)")
    p.add_argument("--output_tts_path", type=str, required=True)
    p.add_argument("--output_rvc_path", type=str, required=True)
    _add_infer_args(p)


def _add_prerequisites_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--models", type=_bool, default=True,
                   help="fetch the missing predictors (rmvpe.pt, fcpe.pt)")
    p.add_argument("--pretraineds_hifigan", type=_bool, default=True,
                   help="fetch the missing default HiFi-GAN pretrains")
    p.add_argument("--exe", type=_bool, default=True,
                   help="reference: fetch ffmpeg.exe; here: build the native "
                        "audio engine")
    p.add_argument("--prime_cache", default="",
                   help="any value: build the three CUDA kernel libraries now "
                        "(nvcc), so that the first conversion does not wait for "
                        "them. Eager PyTorch has no graph to compile ahead, so "
                        "the JAX CLI's list of file lengths in seconds is "
                        "accepted and not used")


def _add_preprocess_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model_name", type=str, required=True)
    p.add_argument("--dataset_path", type=str, required=True)
    p.add_argument("--sample_rate", type=int, required=True,
                   choices=[32000, 40000, 48000])
    p.add_argument("--cpu_cores", type=int, default=None)
    p.add_argument("--cut_preprocess", type=str, default="Automatic",
                   choices=["Skip", "Simple", "Automatic"])
    p.add_argument("--process_effects", type=_bool, default=True)
    p.add_argument("--noise_reduction", type=_bool, default=False)
    p.add_argument("--noise_reduction_strength", type=float, default=0.7)
    p.add_argument("--chunk_len", type=float, default=3.0)
    p.add_argument("--overlap_len", type=float, default=0.3)


def _add_extract_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model_name", type=str, required=True)
    p.add_argument("--f0_method", type=str, default="rmvpe",
                   choices=["crepe", "crepe-tiny", "rmvpe", "fcpe", "yin"])
    p.add_argument("--hop_length", type=int, default=128)
    p.add_argument("--sample_rate", type=int, required=True)
    p.add_argument("--embedder_model", type=str, default="contentvec",
                   choices=["contentvec", "spin", "chinese-hubert-base",
                            "japanese-hubert-base", "korean-hubert-base",
                            "custom"])
    p.add_argument("--embedder_model_custom", type=str, default=None)
    p.add_argument("--include_mutes", type=int, default=2)
    p.add_argument("--rmvpe_ckpt", type=str,
                   default=os.path.join("models", "predictors", "rmvpe.pt"))
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--cpu_cores", type=int, default=None,
                   help="host threads for audio decode during extraction")
    p.add_argument("--gpu", type=str, default="",
                   help="card index to extract on (the first of a dash list)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to extract on (the card by default; "
                        "'cpu' runs the kernels' plain versions)")


def _add_index_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model_name", type=str, required=True)
    p.add_argument("--index_algorithm", type=str, default="Auto",
                   choices=["Auto", "Faiss", "KMeans"])
    p.add_argument("--export_faiss", action="store_true",
                   help="also write a faiss-binary IndexIVFFlat "
                        "(added_IVF{n}_Flat_..._v2.index) for a reference install")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the k-means (the card by default)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="rvc_tpu_torch",
        description="Retrieval-based voice conversion on the GPU (PyTorch/CUDA)")
    sub = parser.add_subparsers(dest="mode", required=True)
    p = sub.add_parser("infer", help="Run single-file inference")
    p.add_argument("--input_path", type=str, required=True)
    p.add_argument("--output_path", type=str, required=True)
    _add_infer_args(p)
    p = sub.add_parser("batch_infer", help="Run folder batch inference")
    p.add_argument("--input_folder", type=str, required=True)
    p.add_argument("--output_folder", type=str, required=True)
    _add_infer_args(p)
    p = sub.add_parser("tts", help="Text-to-speech then voice conversion")
    _add_tts_args(p)
    p = sub.add_parser("preprocess", help="Preprocess a dataset")
    _add_preprocess_args(p)
    p = sub.add_parser("extract", help="Extract F0 + content features")
    _add_extract_args(p)
    p = sub.add_parser("train", help="Train a model")
    _add_train_args(p)
    p = sub.add_parser("index", help="Build the retrieval index")
    _add_index_args(p)
    p = sub.add_parser("model_information", help="Print model metadata")
    p.add_argument("--pth_path", type=str, required=True)
    p = sub.add_parser("model_blender", help="Blend two models")
    p.add_argument("--model_name", type=str, required=True)
    p.add_argument("--pth_path_1", type=str, required=True)
    p.add_argument("--pth_path_2", type=str, required=True)
    p.add_argument("--ratio", type=float, default=0.5)
    p = sub.add_parser("tensorboard", help="Launch metric dashboard")
    p.add_argument("--logdir", type=str, default="logs")
    p.add_argument("--port", type=int, default=9000)
    p = sub.add_parser("download", help="Download a model from a link")
    p.add_argument("--model_link", type=str, required=True)
    p = sub.add_parser("prerequisites", help="Fetch predictor/pretrain assets")
    _add_prerequisites_args(p)
    p = sub.add_parser("audio_analyzer", help="Analyze an audio file")
    p.add_argument("--input_path", type=str, required=True)
    p.add_argument("--save_plot_path", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the statistics (the card by default)")
    return parser


def collect_infer_kwargs(args) -> dict:
    kw = {k: getattr(args, k) for k in INFER_KEYS}
    kw["model_path"] = args.pth_path
    kw["index_path"] = args.index_path
    return kw


def train_config(args):
    """The ExperimentConfig a ``train`` command line asks for."""
    import dataclasses

    from .configs import get_config

    cfg = get_config(args.sample_rate, vocoder=args.vocoder)
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=args.batch_size, optimizer=args.optimizer.lower(),
        use_multiscale_mel=args.use_multiscale_mel_loss,
        double_d_update=args.double_d_update, use_balancer=args.use_balancer,
        use_wgan=args.use_wgan_gp_loss, bf16_run=args.bf16_run,
        use_checkpointing=args.checkpointing,
        warmup_epochs=args.warmup_duration if args.use_warmup else 0))


def trainer_args(args):
    """The TrainerArgs of a ``train`` command line (pretrained files chosen
    as the JAX CLI chooses them)."""
    from .train.trainer import TrainerArgs

    pretrain_g, pretrain_d = args.g_pretrained_path, args.d_pretrained_path
    if args.pretrained and args.custom_pretrained and not (pretrain_g and pretrain_d):
        raise SystemExit("custom_pretrained requires --g_pretrained_path and "
                         "--d_pretrained_path")
    if args.pretrained and not args.custom_pretrained and not (pretrain_g or pretrain_d):
        pretrain_g, pretrain_d = pretrained_selector(args.vocoder, args.sample_rate)
    if args.use_custom_lr and (args.custom_lr_g is None or args.custom_lr_d is None):
        raise SystemExit("use_custom_lr requires --custom_lr_g and --custom_lr_d")
    device_indices = (tuple(int(i) for i in args.gpu.split("-") if i != "")
                      if args.gpu else None)
    return TrainerArgs(
        exp_dir=os.path.join("logs", args.model_name),
        discriminators=args.discriminators, use_orbax=args.use_orbax,
        cache_data=args.cache_data_in_gpu, total_epochs=args.total_epoch,
        save_every_epoch=args.save_every_epoch,
        save_only_latest=args.save_only_latest,
        save_every_weights=args.save_every_weights,
        lr_g=args.custom_lr_g if args.use_custom_lr else None,
        lr_d=args.custom_lr_d if args.use_custom_lr else None,
        device_indices=device_indices,
        pretrain_g=pretrain_g if args.pretrained else "",
        pretrain_d=pretrain_d if args.pretrained else "", device=args.device)


def _train(args) -> int:
    """One process, or with several ``--gpu`` indices one rank a card
    through ``parallel.launch`` (the ranks' exit code)."""
    from .parallel import mesh

    if args.cleanup:
        cleanup_previous_run(os.path.join("logs", args.model_name))
    indices = [i for i in args.gpu.split("-") if i != ""]
    if len(indices) < 2:
        _train_rank(0, None, args)
        return 0
    devices = (["cpu"] * len(indices) if args.device == "cpu"
               else [f"cuda:{i}" for i in indices])
    world = mesh.make_world_for_batch(args.batch_size, devices)
    if len(world) < len(devices):
        print(f"train: batch {args.batch_size} does not divide over "
              f"{len(devices)} cards; leaving out --gpu {'-'.join(indices[len(world):])}")
    args.gpu = "-".join(indices[:len(world)])
    if len(world) == 1:
        _train_rank(0, None, args)
        return 0
    return mesh.launch(_train_rank, world, args=(args,))


def _train_rank(rank: int, device, args) -> None:
    """A ``train`` run in this process: one rank of ``launch`` (its card is
    ``--gpu``'s entry ``rank``), or the only one."""
    import torch

    from .train.trainer import Trainer

    cfg, targs = train_config(args), trainer_args(args)
    # the reference's CUDA switches (train.py): TF32, cuDNN autotuning and
    # determinism
    torch.backends.cuda.matmul.allow_tf32 = args.use_tf32
    torch.backends.cudnn.allow_tf32 = args.use_tf32
    torch.backends.cudnn.benchmark = args.use_benchmark
    torch.backends.cudnn.deterministic = args.use_deterministic
    if args.use_deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    Trainer(cfg, targs).fit()
    if rank != 0:
        return
    from .train.index_builder import build_index

    try:
        print("index:", build_index(targs.exp_dir, algorithm=args.index_algorithm,
                                    device=args.device))
    except FileNotFoundError:
        pass


def _preprocess(args) -> None:
    from .train.preprocess import preprocess_training_set

    exp_dir = os.path.join("logs", args.model_name)
    hours = preprocess_training_set(
        args.dataset_path, args.sample_rate, exp_dir,
        cut_preprocess=args.cut_preprocess, process_effects=args.process_effects,
        noise_reduction=args.noise_reduction,
        reduction_strength=args.noise_reduction_strength,
        chunk_len=args.chunk_len, overlap_len=args.overlap_len,
        num_workers=args.cpu_cores)
    print(f"preprocessed {hours:.2f} h into {exp_dir}")


def _extract(args) -> None:
    from .train.extract import run_extraction

    exp_dir = os.path.join("logs", args.model_name)
    device = f"cuda:{int(args.gpu.split('-')[0])}" if args.gpu else args.device
    run_extraction(
        exp_dir, f0_method=args.f0_method,
        rmvpe_ckpt=args.rmvpe_ckpt if os.path.exists(args.rmvpe_ckpt) else None,
        embedder_ckpt=args.embedder_model_custom,
        include_mutes=args.include_mutes, sample_rate=args.sample_rate,
        batch_size=args.batch_size, embedder_model=args.embedder_model,
        hop_length=args.hop_length, cpu_cores=args.cpu_cores, device=device)
    print(f"extraction complete for {exp_dir}")


def _index(args) -> None:
    from .train.index_builder import build_index

    print(build_index(os.path.join("logs", args.model_name),
                      algorithm=args.index_algorithm,
                      export_faiss=args.export_faiss, device=args.device))


def _model_information(args) -> None:
    from .utils.model_tools import model_information

    model_information(args.pth_path)


def _model_blender(args) -> None:
    from .utils.model_tools import model_blender

    print(model_blender(args.model_name, args.pth_path_1, args.pth_path_2,
                        args.ratio))


def _serve_forever() -> None:
    while True:
        time.sleep(60)


def _tensorboard(args) -> None:
    try:
        from tensorboard import program
    except ImportError:
        print("tensorboard not installed; metrics are in "
              f"{args.logdir}/*/metrics.jsonl")
        return
    tb = program.TensorBoard()
    tb.configure(argv=[None, "--logdir", args.logdir, "--port", str(args.port)])
    print(f"TensorBoard at {tb.launch()}")
    _serve_forever()


def _audio_analyzer(args) -> None:
    from .utils.analyzer import analyze_audio

    analyze_audio(args.input_path, args.save_plot_path, device=args.device)


def _download(args) -> None:
    from .utils.downloads import model_download_pipeline

    print(model_download_pipeline(args.model_link))


def _prerequisites(args) -> None:
    from .utils.downloads import prerequisites_download_pipeline

    prerequisites_download_pipeline(pretraineds_hifigan=args.pretraineds_hifigan,
                                    models=args.models, exe=args.exe)
    if args.prime_cache:
        from .ops import _build

        _build.build()
        print(f"kernel libraries built in {_build.BUILD_DIR}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    runners = {"train": _train, "preprocess": _preprocess,
               "extract": _extract, "index": _index,
               "model_information": _model_information,
               "model_blender": _model_blender, "tensorboard": _tensorboard,
               "audio_analyzer": _audio_analyzer, "download": _download,
               "prerequisites": _prerequisites}
    if args.mode in runners:
        return runners[args.mode](args) or 0
    from .infer.converter import VoiceConverter

    vc = VoiceConverter(precision=args.precision, device=args.device)
    if args.mode == "tts":
        from .utils.tts import run_tts

        text = args.tts_text
        if args.input_path and os.path.exists(args.input_path):
            with open(args.input_path, encoding="utf-8") as f:
                text = f.read()
        if not text:
            raise SystemExit("tts: provide --tts_text or --input_path")
        run_tts(text, args.tts_voice, args.tts_rate, args.output_tts_path)
        vc.convert_audio(audio_input_path=args.output_tts_path,
                         audio_output_path=args.output_rvc_path,
                         **collect_infer_kwargs(args))
    elif args.mode == "infer":
        vc.convert_audio(audio_input_path=args.input_path,
                         audio_output_path=args.output_path,
                         **collect_infer_kwargs(args))
    else:
        vc.convert_audio_batch(audio_input_paths=args.input_folder,
                               audio_output_path=args.output_folder,
                               **collect_infer_kwargs(args))
    return 0


if __name__ == "__main__":
    sys.exit(main())
