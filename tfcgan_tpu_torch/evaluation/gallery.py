"""Static HTML gallery over sample/eval image directories, port of
``tfcgan_tpu.evaluation.gallery``.

NeMAR's HTML visualizer (``nemar/util/visualizer.py:1-231``: an HTML page of
per-epoch image rows) without its Visdom/webpage dependencies: one
self-contained ``index.html`` over the PNGs a run already writes (training
sample stacks, test-set stacks).
"""

from __future__ import annotations

import html
import os

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ font-family: sans-serif; background: #111; color: #ddd; }}
 table {{ border-collapse: collapse; }}
 td {{ padding: 4px 10px; vertical-align: top; }}
 img {{ image-rendering: pixelated; max-height: 512px; }}
 .lab {{ color: #8ac; font-size: 13px; white-space: nowrap; }}
</style></head><body>
<h2>{title}</h2>
{rows}
</body></html>
"""


def write_gallery(image_dir: str, title: str | None = None) -> str:
    """Emit ``index.html`` into ``image_dir`` with one row per PNG/JPG,
    labeled by filename, newest (highest step) first. Returns the written
    path."""
    exts = (".png", ".jpg", ".jpeg", ".webp")
    files = sorted(
        (f for f in os.listdir(image_dir) if f.lower().endswith(exts)), reverse=True
    )
    rows = "\n".join(
        f'<table><tr><td class="lab">{html.escape(f)}</td>'
        f'<td><img src="{html.escape(f)}" loading="lazy"></td></tr></table>'
        for f in files
    )
    page = _PAGE.format(
        title=html.escape(title or os.path.basename(os.path.abspath(image_dir))),
        rows=rows or "<p>(no images yet)</p>",
    )
    out_path = os.path.join(image_dir, "index.html")
    with open(out_path, "w") as f:
        f.write(page)
    return out_path
