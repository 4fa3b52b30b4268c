"""Model and prerequisite installs (port of ``rvc_tpu/utils/downloads.py``).

The reference's prerequisites_download.py (HF pretrains, rmvpe.pt, fcpe.pt)
and model_download.py (Drive / HF / zip links). A local path, a
``file://`` URL and a dropped ``.zip`` / ``.pth`` / ``.index`` bundle
install without the network; a link goes through ``link_resolver`` and
its injectable ``http_get``. ``missing_prerequisites`` only reports, and
fetches nothing: the UI's boot check calls it.
"""

from __future__ import annotations

import os
import shutil
import zipfile
from typing import Callable, List, Optional
from urllib.parse import urlparse

PREDICTORS = ("rmvpe.pt", "fcpe.pt")
PRETRAINED_SR = (32000, 40000, 48000)

MODELS_DIR = "models"

# public asset locations (reference prerequisites_download.py:6-28)
_URL_BASE = "https://huggingface.co/IAHispano/Applio/resolve/main/Resources"
_ASSET_URLS = {
    os.path.join("predictors", "rmvpe.pt"): f"{_URL_BASE}/predictors/rmvpe.pt",
    os.path.join("predictors", "fcpe.pt"): (
        "https://huggingface.co/Codename0/codename-rvc-fork-3-assets"
        "/resolve/main/models/predictors/fcpe"
    ),
}
_ASSET_URLS.update({
    os.path.join("pretraineds", f"{pfx}{sr // 1000}k.pth"):
        f"{_URL_BASE}/pretrained_v2/{pfx}{sr // 1000}k.pth"
    for sr in PRETRAINED_SR for pfx in ("f0G", "f0D")
})


def missing_prerequisites(pretraineds_hifigan: bool = True,
                          models: bool = True) -> List[str]:
    """The predictor and pretrained files that are not under ``models/``."""
    wanted = []
    if models:
        wanted += [os.path.join(MODELS_DIR, "predictors", n) for n in PREDICTORS]
    if pretraineds_hifigan:
        wanted += [os.path.join(MODELS_DIR, "pretraineds", f"{pfx}{sr // 1000}k.pth")
                   for sr in PRETRAINED_SR for pfx in ("f0G", "f0D")]
    return [p for p in wanted if not os.path.exists(p)]


def prerequisites_download_pipeline(
    pretraineds_hifigan: bool = True, models: bool = True, exe: bool = True,
    http_get: Optional[Callable] = None,
) -> List[str]:
    """Fetch the missing predictor and pretrained files (the reference pulls
    them from HF, prerequisites_download.py:6-39) through ``http_get``
    (``requests`` by default), and with ``exe`` (the reference's
    ffmpeg.exe) build the native audio engine. Returns the files still
    missing, after printing where to place them."""
    from .link_resolver import _default_http_get, _iter_content, _raise_for_status

    os.makedirs(os.path.join(MODELS_DIR, "predictors"), exist_ok=True)
    os.makedirs(os.path.join(MODELS_DIR, "pretraineds"), exist_ok=True)
    if exe:
        from .native import get_lib

        if get_lib() is not None:
            print("native audio engine ready")
    missing = missing_prerequisites(pretraineds_hifigan, models)
    if not missing:
        print("all prerequisites present")
        return []
    get = http_get or _default_http_get
    failed = []
    for path in missing:
        url = _ASSET_URLS[os.path.relpath(path, MODELS_DIR)]
        try:
            r = get(url, stream=True)
            _raise_for_status(r, url)
            tmp = path + ".part"
            with open(tmp, "wb") as f:
                for chunk in _iter_content(r):
                    f.write(chunk)
            os.replace(tmp, path)
            print(f"downloaded {path}")
        except Exception as e:  # one failed file does not stop the others
            failed.append(path)
            print(f"fetch failed for {path} ({e})")
    if failed:
        print("could not download everything. Place these files manually:")
        for m in failed:
            print(f"  {m}")
    return failed


def install_model_archive(path: str, output_dir: str = "logs") -> str:
    """Install a dropped model file (a zip of .pth and .index, a bare .pth,
    .npz or .index) into ``output_dir`` (the reference's drag-and-drop
    install). Returns the installed path."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    os.makedirs(output_dir, exist_ok=True)
    if path.endswith(".zip"):
        name = os.path.splitext(os.path.basename(path))[0]
        dest = os.path.join(output_dir, name)
        with zipfile.ZipFile(path) as z:
            z.extractall(dest)
        return dest
    if path.endswith((".pth", ".npz", ".index")):
        dest = os.path.join(output_dir, os.path.basename(path))
        shutil.copy2(path, dest)
        return dest
    raise ValueError(f"unsupported model file {path!r} (.zip/.pth/.npz/.index)")


def model_download_pipeline(model_link: str, output_dir: str = "logs",
                            http_get: Optional[Callable] = None) -> str:
    """Install a model from a link or a path (reference
    model_download.py:160-196): local paths and ``file://`` URLs, Google
    Drive share links, HF /blob/, /resolve/ and /tree/ links, and .zip
    archives (unpacked, ``__MACOSX`` dropped). ``http_get`` is the
    transport of a link."""
    parsed = urlparse(model_link)
    local = parsed.path if parsed.scheme in ("", "file") else None
    os.makedirs(output_dir, exist_ok=True)

    if local and os.path.exists(local):
        dest = install_model_archive(local, output_dir)
        print(f"installed {dest}")
        return dest

    from .link_resolver import download_link

    try:
        path = download_link(model_link, output_dir, http_get=http_get)
    except Exception as e:
        raise RuntimeError(
            f"download failed ({e}); without network access pass a local "
            "path or file:// URL") from e
    if path.endswith(".zip"):
        out = path[:-4]
        with zipfile.ZipFile(path) as z:
            z.extractall(out)
        os.remove(path)
        mac = os.path.join(out, "__MACOSX")
        if os.path.isdir(mac):
            shutil.rmtree(mac)
        return out
    return path
