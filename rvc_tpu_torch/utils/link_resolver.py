"""Model-link resolution: Google Drive, HuggingFace, zips, direct files
(port of ``rvc_tpu/utils/link_resolver.py``, which is stdlib only; the port
keeps its own copy).

The reference's front-door link handling (rvc/lib/tools/model_download.py:
37-196 and the vendored gdown.py): Drive share links need the uc?id= +
confirm-token dance for large files; HF /blob/ links are rewritten to
/resolve/; /tree/main pages are scraped for a .zip. All network I/O goes
through an injectable `http_get`, so the logic is testable offline and
fails with a clear error without network access.
"""

from __future__ import annotations

import os
import re
from typing import Callable, Iterable, List, Optional, Tuple
from urllib.parse import parse_qs, unquote, urlparse


class LinkResolveError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# Google Drive
# ---------------------------------------------------------------------------

_GDRIVE_PATH_PATTERNS = (
    r"^/file/d/([^/]+)",
    r"^/file/u/[0-9]+/d/([^/]+)",
    r"^/document/d/([^/]+)",
    r"^/presentation/d/([^/]+)",
    r"^/spreadsheets/d/([^/]+)",
)


def parse_gdrive_id(url: str) -> Optional[str]:
    """File id from any common Drive URL shape (gdown.py:31-76)."""
    parsed = urlparse(url)
    if parsed.hostname not in ("drive.google.com", "docs.google.com",
                               "drive.usercontent.google.com"):
        return None
    q = parse_qs(parsed.query)
    if "id" in q:
        return q["id"][0]
    for pat in _GDRIVE_PATH_PATTERNS:
        m = re.match(pat, parsed.path)
        if m:
            return m.group(1)
    return None


def gdrive_confirm_url(html: str) -> str:
    """Download URL from the Drive interstitial ("can't scan for viruses")
    page (gdown.py:82-118): either an /uc?export=download href, the
    usercontent form (id + uuid hidden inputs), or an embedded
    downloadUrl JSON field."""
    m = re.search(r'href="(/uc\?export=download[^"]+)"', html)
    if m:
        return "https://docs.google.com" + m.group(1).replace("&amp;", "&")
    m = re.search(
        r'<form[^>]+action="(https://drive\.usercontent\.google\.com/'
        r'download)"', html)
    if m:
        action = m.group(1)
        fields = dict(re.findall(
            r'<input\s+type="hidden"\s+name="([^"]+)"\s+value="([^"]*)"',
            html,
        ))
        if "id" in fields:
            query = "&".join(f"{k}={v}" for k, v in fields.items())
            return f"{action}?{query}"
    m = re.search(r'href="/open\?id=([^"]+)"', html)
    if m:
        uid = re.search(
            r'<input\s+type="hidden"\s+name="uuid"\s+value="([^"]+)"', html)
        if uid:
            return ("https://drive.usercontent.google.com/download?id="
                    + m.group(1) + "&confirm=t&uuid=" + uid.group(1))
    m = re.search(r'"downloadUrl":"([^"]+)', html)
    if m:
        return m.group(1).replace("\\u003d", "=").replace("\\u0026", "&")
    m = re.search(r'<p class="uc-error-subcaption">(.*?)</p>', html)
    if m:
        raise LinkResolveError(f"Google Drive: {m.group(1)}")
    raise LinkResolveError(
        "cannot retrieve the Drive file link; the file may not be shared "
        "as 'Anyone with the link', or has seen too many downloads"
    )


# ---------------------------------------------------------------------------
# filename extraction
# ---------------------------------------------------------------------------

def filename_from_headers(headers: dict, url: str) -> str:
    cd = unquote(headers.get("Content-Disposition", "") or "")
    m = (re.search(r"filename\*=UTF-8''([^;]+)", cd)
         or re.search(r'filename=["\']?([^"\';]+)', cd))
    if m:
        return m.group(1).strip().replace(os.path.sep, "_")
    name = os.path.basename(urlparse(url).path)
    return unquote(name) or "downloaded_file"


# ---------------------------------------------------------------------------
# resolver + downloader
# ---------------------------------------------------------------------------

def _default_http_get(url: str, stream: bool = True):
    import requests

    return requests.get(url, stream=stream, timeout=120, allow_redirects=True)


def scrape_zip_link(html: str, base: str = "https://huggingface.co") -> str:
    """First .zip href on an HF /tree/main page (model_download.py:106-124),
    rewritten /blob/ -> /resolve/."""
    for href in re.findall(r'href="([^"]+\.zip)"', html):
        url = href.replace("/blob/", "/resolve/")
        if not url.startswith("http"):
            url = base + url
        return url
    raise LinkResolveError("no .zip link found on the page")


def download_link(
    url: str,
    dest_dir: str,
    http_get: Optional[Callable] = None,
    max_hops: int = 6,
) -> str:
    """Resolve + download `url` into dest_dir; returns the file path.

    Handles: Drive share links (confirm dance), HF /blob/ and /resolve/
    links, HF /tree/main pages (first .zip), and plain direct URLs.
    """
    get = http_get or _default_http_get
    os.makedirs(dest_dir, exist_ok=True)

    gid = parse_gdrive_id(url)
    if gid and "usercontent" not in (urlparse(url).hostname or ""):
        url = f"https://drive.google.com/uc?id={gid}"
    elif "/blob/" in url:
        url = url.replace("/blob/", "/resolve/")
    elif "/tree/main" in url:
        r = get(url, stream=False)
        _raise_for_status(r, url)
        parsed = urlparse(url)
        url = scrape_zip_link(_text(r),
                              base=f"{parsed.scheme}://{parsed.netloc}")

    for _ in range(max_hops):
        r = get(url, stream=True)
        _raise_for_status(r, url)
        ctype = (r.headers.get("Content-Type") or "").lower()
        if gid and ctype.startswith("text/html") \
                and "Content-Disposition" not in r.headers:
            # Drive interstitial page -> extract the confirmed URL and retry
            url = gdrive_confirm_url(_text(r))
            continue
        name = filename_from_headers(r.headers, url)
        path = os.path.join(dest_dir, name)
        tmp = path + ".part"
        with open(tmp, "wb") as f:
            for chunk in _iter_content(r):
                f.write(chunk)
        os.replace(tmp, path)
        return path
    raise LinkResolveError(f"too many confirmation redirects for {url}")


def _raise_for_status(r, url: str) -> None:
    code = getattr(r, "status_code", 200)
    if code >= 400:
        raise LinkResolveError(f"download failed with status {code}: {url}")


def _text(r) -> str:
    t = getattr(r, "text", None)
    if t is not None:
        return t
    return r.content.decode("utf-8", errors="replace")


def _iter_content(r) -> Iterable[bytes]:
    it = getattr(r, "iter_content", None)
    if it is not None:
        return it(chunk_size=1 << 20)
    return [r.content]


def search_pth_index(folder: str) -> Tuple[List[str], List[str]]:
    """(pth_paths, index_paths) in folder (model_download.py:23-34)."""
    pths, idxs = [], []
    for name in sorted(os.listdir(folder)):
        p = os.path.join(folder, name)
        if not os.path.isfile(p):
            continue
        if name.endswith(".pth"):
            pths.append(p)
        elif name.endswith(".index"):
            idxs.append(p)
    return pths, idxs
