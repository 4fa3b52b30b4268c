"""The audio slicer (port of ``rvc_tpu/utils/slice_gui.py``): ``slice_file``
cuts one file into fixed-length or silence-separated chunks for a
dataset, and a tkinter window drives it.

    python -m rvc_tpu_torch.utils.slice_gui [in.wav out_dir --mode silence]
                                            # no file: the window

Two modes: "fixed", back-to-back windows of ``slice_ms`` milliseconds;
"silence", the preprocessing ``Slicer`` (RMS silence detection), each
slice written whole.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..train.preprocess import Slicer
from .audio_io import read_audio, resample, save_audio, to_mono


def slice_file(input_path: str, output_dir: str, mode: str = "fixed",
               slice_ms: int = 3000, sample_rate: Optional[int] = None,
               min_keep_ms: int = 300) -> List[str]:
    """Cut ``input_path`` into chunk WAVs under ``output_dir``; returns the
    written paths. Chunks shorter than ``min_keep_ms`` are dropped."""
    audio, sr = read_audio(input_path)
    audio = to_mono(audio).astype(np.float32)
    if sample_rate is not None and sr != sample_rate:
        audio = resample(audio, sr, sample_rate)
        sr = sample_rate
    if mode == "fixed":
        step = max(1, int(sr * slice_ms / 1000))
        chunks = [audio[i:i + step] for i in range(0, len(audio), step)]
    elif mode == "silence":
        chunks = Slicer(sr=sr).slice(audio)
    else:
        raise ValueError(f"unknown slice mode {mode!r} (fixed|silence)")
    os.makedirs(output_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(input_path))[0]
    min_keep = int(sr * min_keep_ms / 1000)
    written = []
    for i, chunk in enumerate(chunks):
        if len(chunk) < min_keep:
            continue
        out = os.path.join(output_dir, f"{base}_{i:04d}.wav")
        save_audio(out, chunk, sr)
        written.append(out)
    return written


def launch_gui() -> None:  # pragma: no cover - needs a display
    """A tkinter window over ``slice_file`` (a file picker where the
    reference drops files with tkinterdnd2, which is not stdlib)."""
    import tkinter as tk
    from tkinter import filedialog, messagebox, ttk

    root = tk.Tk()
    root.title("rvc_tpu_torch audio slicer")
    root.geometry("520x260")

    state = {"input": None, "output": None}
    mode_var = tk.StringVar(value="fixed")
    ms_var = tk.StringVar(value="3000")

    info = ttk.Label(root, text="No file selected")
    info.pack(pady=6, fill=tk.X, padx=10)

    def pick_input():
        p = filedialog.askopenfilename(
            filetypes=[("Audio", "*.wav *.flac"), ("All", "*.*")])
        if p:
            state["input"] = p
            audio, sr = read_audio(p)
            info.config(text=f"{os.path.basename(p)} — {sr} Hz, {len(audio) / sr:.1f}s")

    def pick_output():
        p = filedialog.askdirectory()
        if p:
            state["output"] = p

    def run():
        if not state["input"] or not state["output"]:
            messagebox.showerror("slice", "pick an input file and output dir")
            return
        try:
            out = slice_file(state["input"], state["output"], mode=mode_var.get(),
                             slice_ms=int(ms_var.get()))
            messagebox.showinfo("slice", f"wrote {len(out)} chunks")
        except Exception as e:  # shown in the dialog, as the reference does
            messagebox.showerror("slice", str(e))

    ttk.Button(root, text="Choose audio...", command=pick_input).pack(pady=4)
    ttk.Button(root, text="Choose output folder...", command=pick_output).pack(pady=4)
    row = ttk.Frame(root)
    row.pack(pady=4)
    ttk.Radiobutton(row, text="Fixed length", variable=mode_var,
                    value="fixed").pack(side=tk.LEFT, padx=6)
    ttk.Radiobutton(row, text="Silence-based", variable=mode_var,
                    value="silence").pack(side=tk.LEFT, padx=6)
    ttk.Entry(row, textvariable=ms_var, width=8).pack(side=tk.LEFT, padx=6)
    ttk.Label(row, text="ms").pack(side=tk.LEFT)
    ttk.Button(root, text="Slice", command=run).pack(pady=10)
    root.mainloop()


def main(argv=None) -> None:
    """Slice the file given into the directory given, or open the window
    without them."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", nargs="?", help="audio file (omit for the window)")
    ap.add_argument("output", nargs="?", help="output directory")
    ap.add_argument("--mode", default="fixed", choices=("fixed", "silence"))
    ap.add_argument("--slice_ms", type=int, default=3000)
    args = ap.parse_args(argv)
    if args.input and args.output:
        paths = slice_file(args.input, args.output, mode=args.mode,
                           slice_ms=args.slice_ms)
        print(f"wrote {len(paths)} chunks to {args.output}")
    else:
        launch_gui()


if __name__ == "__main__":
    main()
