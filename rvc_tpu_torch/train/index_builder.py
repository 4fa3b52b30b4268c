"""Retrieval-index builder (port of ``rvc_tpu/train/index_builder.py``).

Concatenates every ``extracted/*.npy`` content feature of an experiment,
shuffles the rows with a seeded numpy generator, compresses them to
10 000 k-means centroids when there are more than 200 000 rows (or always,
under ``KMeans``), and writes the matrix as ``<model>.index.npz``. The
k-means runs on ``device``: on the card its assignment step is kernel K3
(``ops/retrieval.py`` ``kmeans``). Search is exact, so the index is the
plain matrix; ``export_faiss`` also writes it as a faiss ``IndexIVFFlat``
for a reference install.
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..ops.retrieval import FeatureIndex, kmeans

MAX_ROWS_BEFORE_COMPRESSION = 2 * 10**5
N_CENTROIDS = 10_000


def build_index(
    exp_dir: str,
    output_path: Optional[str] = None,
    seed: int = 1234,
    max_rows: int = MAX_ROWS_BEFORE_COMPRESSION,
    n_centroids: int = N_CENTROIDS,
    algorithm: str = "Auto",
    export_faiss: bool = False,
    device: Union[str, torch.device] = "cuda",
) -> str:
    """Build ``<model>.index.npz`` from ``<exp_dir>/extracted/*.npy`` and
    return its path.

    algorithm: "Auto" compresses only above ``max_rows``, "KMeans" always
    compresses to ``n_centroids``, "Faiss" never does. ``export_faiss``
    also writes ``added_IVF{n}_Flat_nprobe_1_{model}_v2.index`` beside it.
    """
    dev = resolve_device(device)
    feature_dir = os.path.join(exp_dir, "extracted")
    paths = sorted(glob.glob(os.path.join(feature_dir, "*.npy")))
    if not paths:
        raise FileNotFoundError(f"no extracted features under {feature_dir}")

    feats = np.concatenate([np.load(p) for p in paths], axis=0).astype(np.float32)
    np.random.default_rng(seed).shuffle(feats)

    compress = (feats.shape[0] > max_rows if algorithm == "Auto"
                else algorithm.lower() == "kmeans")
    if compress and feats.shape[0] > n_centroids:
        feats = kmeans(torch.from_numpy(feats).to(dev), n_centroids,
                       seed=seed).cpu().numpy()

    model_name = os.path.basename(os.path.normpath(exp_dir))
    if output_path is None:
        output_path = os.path.join(exp_dir, f"{model_name}.index.npz")
    FeatureIndex(feats, device="cpu").save(output_path)
    if export_faiss:
        from ..utils.faiss_io import default_nlist, write_index_ivf_flat

        nlist = default_nlist(feats.shape[0])
        faiss_path = os.path.join(
            os.path.dirname(output_path),
            f"added_IVF{nlist}_Flat_nprobe_1_{model_name}_v2.index")
        write_index_ivf_flat(faiss_path, feats, nlist=nlist, seed=seed)
    return output_path
