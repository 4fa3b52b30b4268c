"""The standalone model blender (port of ``rvc_tpu/utils/blender_gui.py``;
the reference's EXTRAS/model_blender_gui.py:38-231): ``normalize_sr``
("48k" -> 48000), ``model_blender``, and a tkinter window over them.

    python -m rvc_tpu_torch.utils.blender_gui [a.pth b.pth --name blend
        --ratio 0.5 --output_dir logs]     # no models: the window
"""

from __future__ import annotations

from .checkpoints import normalize_sr
from .model_tools import model_blender

__all__ = ["launch_gui", "main", "model_blender", "normalize_sr"]


def launch_gui() -> None:  # pragma: no cover - needs a display
    import tkinter as tk
    from tkinter import filedialog, messagebox, ttk

    root = tk.Tk()
    root.title("rvc_tpu_torch model blender")
    root.geometry("520x240")

    paths = {"a": None, "b": None, "out": "logs"}
    name_var = tk.StringVar(value="blend")
    ratio_var = tk.DoubleVar(value=0.5)

    def picker(slot, label):
        def pick():
            p = filedialog.askopenfilename(
                filetypes=[("Models", "*.pth *.npz"), ("All", "*.*")])
            if p:
                paths[slot] = p
                label.config(text=p.split("/")[-1])
        return pick

    for slot, text in (("a", "Model A"), ("b", "Model B")):
        row = ttk.Frame(root)
        row.pack(pady=4, fill=tk.X, padx=10)
        lbl = ttk.Label(row, text="(none)")
        ttk.Button(row, text=f"{text}...", command=picker(slot, lbl)).pack(side=tk.LEFT)
        lbl.pack(side=tk.LEFT, padx=8)

    row = ttk.Frame(root)
    row.pack(pady=4)
    ttk.Label(row, text="Name").pack(side=tk.LEFT)
    ttk.Entry(row, textvariable=name_var, width=16).pack(side=tk.LEFT, padx=6)
    ttk.Label(row, text="Ratio A→B").pack(side=tk.LEFT)
    ttk.Scale(row, from_=0.0, to=1.0, variable=ratio_var, length=140).pack(
        side=tk.LEFT, padx=6)

    def run():
        if not paths["a"] or not paths["b"]:
            messagebox.showerror("blend", "pick both models")
            return
        try:
            out = model_blender(name_var.get(), paths["a"], paths["b"],
                                ratio=float(ratio_var.get()), output_dir=paths["out"])
            messagebox.showinfo("blend", f"wrote {out}")
        except Exception as e:  # shown in the dialog, as the reference does
            messagebox.showerror("blend", str(e))

    ttk.Button(root, text="Blend", command=run).pack(pady=10)
    root.mainloop()


def main(argv=None) -> None:
    """Blend the two models given, or open the window without them."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("model_a", nargs="?")
    ap.add_argument("model_b", nargs="?")
    ap.add_argument("--name", default="blend")
    ap.add_argument("--ratio", type=float, default=0.5)
    ap.add_argument("--output_dir", default="logs")
    args = ap.parse_args(argv)
    if args.model_a and args.model_b:
        print(model_blender(args.name, args.model_a, args.model_b, ratio=args.ratio,
                            output_dir=args.output_dir))
    else:
        launch_gui()


if __name__ == "__main__":
    main()
