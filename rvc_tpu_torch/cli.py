"""Command line of the port: the ``infer`` and ``batch_infer`` subcommands
(port of ``rvc_tpu/cli.py``'s), run on the card.

    python -m rvc_tpu_torch.cli infer --input_path in.wav --output_path out.wav \\
        --pth_path model.pth --index_path model.index [--device cuda]
    python -m rvc_tpu_torch.cli batch_infer --input_folder in/ --output_folder out/ \\
        --pth_path model.pth

The parser is the port's own copy of the JAX CLI's argument surface for
these subcommands, flag for flag, so that a command line written for it
parses unchanged; ``--device`` (default ``cuda``) is added. Options the port
does not serve yet (f0 methods other than ``rmvpe``, formant shifting, the
post-FX chain, ``--clean_audio``, formats other than WAV) raise
``NotImplementedError`` when set. ``main(argv)`` returns the exit code.
"""

from __future__ import annotations

import argparse
import sys


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
    return parser


def collect_infer_kwargs(args) -> dict:
    kw = {k: getattr(args, k) for k in INFER_KEYS}
    kw["model_path"] = args.pth_path
    kw["index_path"] = args.index_path
    return kw


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .infer.converter import VoiceConverter

    vc = VoiceConverter(precision=args.precision, device=args.device)
    if args.mode == "infer":
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
