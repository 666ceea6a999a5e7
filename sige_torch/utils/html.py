"""Minimal HTML gallery generator — the port of ``sige_tpu.utils.html``
(reference: diffusion/html_visualize.py uses the dominate package; this
writes plain HTML, no dependency)."""

from __future__ import annotations

import html
import os
from typing import Dict, List


def write_gallery(path: str, rows: List[Dict[str, str]], title: str = "results",
                  width: int = 256) -> None:
    """``rows``: list of {column_name: image_path} dicts; columns are the
    union of keys in order of first appearance."""
    cols: List[str] = []
    for row in rows:
        for k in row:
            if k not in cols:
                cols.append(k)
    out = [f"<!DOCTYPE html><html><head><title>{html.escape(title)}</title>",
           "<style>table{border-collapse:collapse}td,th{border:1px solid #999;"
           "padding:4px;text-align:center;font-family:sans-serif}</style>",
           "</head><body>", f"<h1>{html.escape(title)}</h1>", "<table><tr>"]
    out += [f"<th>{html.escape(c)}</th>" for c in cols]
    out.append("</tr>")
    base = os.path.dirname(os.path.abspath(path))
    for row in rows:
        out.append("<tr>")
        for c in cols:
            v = row.get(c, "")
            if v and os.path.splitext(v)[1].lower() in (".png", ".jpg", ".jpeg", ".webp"):
                rel = os.path.relpath(os.path.abspath(v), base)
                out.append(f'<td><img src="{html.escape(rel)}" width="{width}"></td>')
            else:
                out.append(f"<td>{html.escape(str(v))}</td>")
        out.append("</tr>")
    out += ["</table></body></html>"]
    os.makedirs(base, exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(out))
