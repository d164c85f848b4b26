"""Weight and gradient histograms with per-tensor stats, port of
``tfcgan_tpu.train.histograms`` (NeMAR's TensorBoard ``add_histogram`` of
every parameter and its gradient, without TensorBoard).

``tree_histograms`` computes each tensor's histogram and stats on the
tensor's device, one call a tensor, and leaves them there: the host reads
nothing until ``HistogramLogger.write`` copies a record's results in one
transfer and appends it as a JSONL line, in the JAX logger's schema.
``write_histogram_html`` renders the log as a static page of SVG small
multiples (the JAX package's renderer, copied). The bins are the JAX ones:
equal-width over [min, max] of the tensor, ``(v - lo) / max(hi - lo, 1e-12) *
bins`` in float32 (the span a tensor: a true division on CUDA too),
truncated, clipped to the last bin, counted exactly.

Usage::

    hists = tree_histograms({"G": dict(state.G.named_parameters())})
    logger = HistogramLogger("run/hists.jsonl")
    logger.write(step=state.step, kind="weights", hists=hists)
    write_histogram_html("run/hists.jsonl", "run/hists.html")

``Trainer.fit(..., hist_logger=..., hist_every=N)`` logs the weights after
the update and the step's gradients every N loop steps.
"""

from __future__ import annotations

import json
import os

import torch

STATS = ("lo", "hi", "mean", "std", "l2")


def _leaf_histogram(x: torch.Tensor, bins: int) -> dict[str, torch.Tensor]:
    """Histogram and summary stats of one tensor, float32, on its device."""
    v = x.detach().reshape(-1).float()
    lo, hi = torch.aminmax(v)
    span = torch.clamp_min(hi - lo, 1e-12)
    idx = torch.clamp(((v - lo) / span * bins).to(torch.int32), 0, bins - 1)
    # l2 through torch.sum's cascaded sum: the CPU vector_norm of a float32
    # tensor of 0.5M elements is 3e-5 off (JAX's 1e-8)
    return {"counts": torch.bincount(idx.long(), minlength=bins), "lo": lo, "hi": hi,
            "mean": v.mean(), "std": v.std(correction=0), "l2": v.square().sum().sqrt()}


def tree_histograms(tree, bins: int = 64):
    """Per-tensor histograms of a nested dict of tensors (parameters or
    gradients): the same structure with stat dicts (device tensors) at the
    leaves."""
    if isinstance(tree, torch.Tensor):
        return _leaf_histogram(tree, bins)
    return {k: tree_histograms(v, bins) for k, v in tree.items()}


def _flatten(tree, prefix: str = "") -> dict:
    """{'G/down1.conv.weight': stat_dict, ...} from a nested stats tree."""
    if "counts" in tree and "lo" in tree:
        return {prefix.rstrip("/"): tree}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}{k}/"))
    return out


class HistogramLogger:
    """Appends one JSONL record a (step, kind) with every tensor's histogram:
    {"step", "kind", "leaves": {name: {"counts", "lo", "hi", "mean", "std",
    "l2"}}}."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "a")

    def write(self, step: int, kind: str, hists) -> None:
        flat = _flatten(hists)
        names = list(flat)
        # one device-to-host copy for the counts and one for the stats
        counts = torch.stack([flat[n]["counts"] for n in names]).cpu().tolist()
        stats = torch.stack([torch.stack([flat[n][s] for s in STATS])
                             for n in names]).cpu().tolist()
        rec = {"step": int(step), "kind": kind, "leaves": {
            n: {"counts": c, **dict(zip(STATS, s))} for n, c, s in zip(names, counts, stats)}}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


# --------------------------------------------------------------------- HTML

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ font-family: sans-serif; background: #111; color: #ddd; }}
 .leaf {{ display: inline-block; margin: 6px; vertical-align: top; }}
 .lab {{ color: #8ac; font-size: 11px; max-width: 240px; overflow: hidden;
         text-overflow: ellipsis; white-space: nowrap; }}
 .meta {{ color: #888; font-size: 10px; }}
 svg {{ background: #181818; }}
 h3 {{ margin: 18px 4px 6px; color: #ccc; }}
</style></head><body>
<h2>{title}</h2>
{sections}
</body></html>
"""


def _svg_hist(counts: list[int], width: int = 240, height: int = 60,
              color: str = "#6ab0f3") -> str:
    n = len(counts)
    peak = max(max(counts), 1)
    bw = width / n
    bars = "".join(
        f'<rect x="{i * bw:.1f}" y="{height * (1 - c / peak):.1f}" '
        f'width="{bw:.1f}" height="{height * c / peak:.1f}" fill="{color}"/>'
        for i, c in enumerate(counts) if c
    )
    return f'<svg width="{width}" height="{height}">{bars}</svg>'


def _svg_series(rows: list[list[int]], width: int = 240, row_h: int = 6,
                color: str = "#6ab0f3", max_rows: int = 16) -> str:
    """Histogram-over-steps heatmap (x = bin, y = step, opacity = count) —
    the static equivalent of TensorBoard's stacked histogram view."""
    rows = rows[-max_rows:]
    n = len(rows[0])
    bw = width / n
    cells = []
    for r, counts in enumerate(rows):
        peak = max(max(counts), 1)
        for i, c in enumerate(counts):
            if c:
                cells.append(
                    f'<rect x="{i * bw:.1f}" y="{r * row_h}" width="{bw:.1f}" '
                    f'height="{row_h}" fill="{color}" '
                    f'opacity="{0.15 + 0.85 * c / peak:.2f}"/>'
                )
    return (f'<svg width="{width}" height="{len(rows) * row_h}">'
            + "".join(cells) + "</svg>")


def write_histogram_html(jsonl_path: str, out_path: str | None = None,
                         title: str | None = None) -> str:
    """Render the JSONL log as one section per kind: the newest histogram per
    leaf plus a step-evolution heatmap when several records exist. Returns
    the written path."""
    history: dict[str, list[dict]] = {}
    with open(jsonl_path) as f:
        for line in f:
            rec = json.loads(line)
            history.setdefault(rec["kind"], []).append(rec)
    sections = []
    for kind in sorted(history):
        recs = sorted(history[kind], key=lambda r: r["step"])
        rec = recs[-1]
        color = "#6ab0f3" if kind == "weights" else "#f3a66a"
        cells = []
        for name, st in rec["leaves"].items():
            series = [r["leaves"][name]["counts"] for r in recs
                      if name in r["leaves"]]
            plot = (_svg_series(series, color=color) if len(series) > 1
                    else _svg_hist(st["counts"], color=color))
            cells.append(
                '<div class="leaf">'
                f'<div class="lab" title="{name}">{name}</div>'
                f'{plot}'
                f'<div class="meta">[{st["lo"]:.3g}, {st["hi"]:.3g}] '
                f'μ {st["mean"]:.3g} σ {st["std"]:.3g} ‖·‖ {st["l2"]:.3g}</div>'
                "</div>"
            )
        sections.append(
            f'<h3>{kind} @ step {rec["step"]} '
            f'({len(recs)} records)</h3>\n' + "\n".join(cells))
    page = _PAGE.format(
        title=title or os.path.basename(jsonl_path), sections="\n".join(sections)
    )
    out_path = out_path or os.path.splitext(jsonl_path)[0] + ".html"
    with open(out_path, "w") as f:
        f.write(page)
    return out_path
