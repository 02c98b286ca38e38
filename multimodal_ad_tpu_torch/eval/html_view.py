"""Self-contained interactive HTML volume/ROI viewer (port of the TPU
package's eval/html_view.py; the page it writes is the same bytes).

The reference's atlas query tool and ROI overlay emit interactive nilearn
`view_img` HTML. This module writes a single standalone HTML file with no
external dependency:

- the volume (uint8 intensity) and the ROI label volume (uint16) are
  embedded as base64 typed arrays and rendered client-side on three
  orthogonal <canvas> views (axial/coronal/sagittal),
- per-view slice sliders + an overlay-alpha slider,
- mouse position readout: voxel index, intensity, and ROI name from the
  embedded LUT (the reference tool's query_voxel interaction).

It needs numpy only; the page renders offline in any browser.
"""

from __future__ import annotations

import base64
import html as _html
import json

import numpy as np

_PAGE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>__TITLE__</title>
<style>
 body { background:#111; color:#ddd; font-family:sans-serif; margin:16px; }
 .views { display:flex; gap:16px; flex-wrap:wrap; }
 .view { text-align:center; }
 canvas { image-rendering:pixelated; border:1px solid #444;
          background:#000; cursor:crosshair; }
 input[type=range] { width:220px; }
 #readout { margin-top:12px; font-size:14px; color:#9cf; min-height:1.2em; }
 h2 { font-size:16px; font-weight:normal; }
</style>
</head>
<body>
<h2>__TITLE__</h2>
<div class="views">
 <div class="view"><div>axial (z)</div><canvas id="c2"></canvas><br>
  <input type="range" id="s2" min="0"></div>
 <div class="view"><div>coronal (y)</div><canvas id="c1"></canvas><br>
  <input type="range" id="s1" min="0"></div>
 <div class="view"><div>sagittal (x)</div><canvas id="c0"></canvas><br>
  <input type="range" id="s0" min="0"></div>
</div>
<div>overlay alpha <input type="range" id="alpha" min="0" max="100"
 value="50"></div>
<div id="readout">hover a view to query voxels</div>
<script>
const DIMS = __DIMS__;           // [X, Y, Z]
const SCALE = __SCALE__;         // canvas zoom factor
const LUT = __LUT__;             // {roi_id: name}
const VOL = b64ToArr("__VOL__", Uint8Array);
const LAB = __LAB_EXPR__;
function b64ToArr(b64, T) {
  if (!b64.length) return null;
  const raw = atob(b64); const u8 = new Uint8Array(raw.length);
  for (let i = 0; i < raw.length; i++) u8[i] = raw.charCodeAt(i);
  return new T(u8.buffer);
}
// C-order [x][y][z] flattened: idx = (x*Y + y)*Z + z
function vox(a, x, y, z) { return a[(x * DIMS[1] + y) * DIMS[2] + z]; }
function roiColor(id) {  // stable hash -> warm palette
  const h = (id * 2654435761) >>> 0;
  return [180 + (h % 76), 40 + ((h >> 8) % 160), 30 + ((h >> 16) % 60)];
}
const axes = [0, 1, 2];
const planes = { 0: [1, 2], 1: [0, 2], 2: [0, 1] };  // in-plane dims
function draw(axis) {
  const [da, db] = planes[axis];
  const W = DIMS[da], H = DIMS[db];
  const cv = document.getElementById("c" + axis);
  const slice = +document.getElementById("s" + axis).value;
  const alpha = +document.getElementById("alpha").value / 100;
  cv.width = W; cv.height = H;
  cv.style.width = (W * SCALE) + "px"; cv.style.height = (H * SCALE) + "px";
  const ctx = cv.getContext("2d");
  const img = ctx.createImageData(W, H);
  const p = [0, 0, 0];
  p[axis] = slice;
  for (let b = 0; b < H; b++) {
    for (let a = 0; a < W; a++) {
      p[da] = a; p[db] = H - 1 - b;
      let r, g, bl;
      r = g = bl = vox(VOL, p[0], p[1], p[2]);
      if (LAB) {
        const id = vox(LAB, p[0], p[1], p[2]);
        if (id > 0) {
          const c = roiColor(id);
          r = (1 - alpha) * r + alpha * c[0];
          g = (1 - alpha) * g + alpha * c[1];
          bl = (1 - alpha) * bl + alpha * c[2];
        }
      }
      const o = (b * W + a) * 4;
      img.data[o] = r; img.data[o + 1] = g; img.data[o + 2] = bl;
      img.data[o + 3] = 255;
    }
  }
  ctx.putImageData(img, 0, 0);
}
function redraw() { axes.forEach(draw); }
axes.forEach(axis => {
  const s = document.getElementById("s" + axis);
  s.max = DIMS[axis] - 1; s.value = Math.floor(DIMS[axis] / 2);
  s.addEventListener("input", () => draw(axis));
  const cv = document.getElementById("c" + axis);
  cv.addEventListener("mousemove", ev => {
    const [da, db] = planes[axis];
    const rect = cv.getBoundingClientRect();
    const a = Math.floor((ev.clientX - rect.left) / rect.width * DIMS[da]);
    const b = Math.floor((ev.clientY - rect.top) / rect.height * DIMS[db]);
    const p = [0, 0, 0];
    p[axis] = +document.getElementById("s" + axis).value;
    p[da] = a; p[db] = DIMS[db] - 1 - b;
    if (p.some((v, i) => v < 0 || v >= DIMS[i])) return;
    const v = vox(VOL, p[0], p[1], p[2]);
    let msg = `voxel (${p[0]}, ${p[1]}, ${p[2]})  intensity ${v}`;
    if (LAB) {
      const id = vox(LAB, p[0], p[1], p[2]);
      msg += id > 0 ? `  ROI ${id}: ${LUT[id] || ("ROI" + id)}`
                    : "  (background)";
    }
    document.getElementById("readout").textContent = msg;
  });
});
document.getElementById("alpha").addEventListener("input", redraw);
redraw();
</script>
</body>
</html>
"""


def _to_uint8(vol: np.ndarray) -> np.ndarray:
    v = np.asarray(vol, np.float32)
    lo, hi = float(np.nanmin(v)), float(np.nanmax(v))
    if hi <= lo:
        return np.zeros(v.shape, np.uint8)
    return ((v - lo) / (hi - lo) * 255).astype(np.uint8)


def save_interactive_html(vol: np.ndarray, out_html: str,
                          labels: np.ndarray | None = None,
                          roi_names_by_id: dict | None = None,
                          roi_ids=None, title: str = "volume viewer") -> str:
    """Write a standalone interactive viewer for `vol` (X, Y, Z), optionally
    overlaying `labels` (int ROI volume on the same grid, restricted to
    `roi_ids` when given) with the {id: name} LUT for hover queries.

    Returns `out_html` (reference ROL_visual.py:55-66 `view_img(...)
    .save_as_html` parity, without nilearn)."""
    vol = np.asarray(vol)
    if vol.ndim != 3:
        raise ValueError(f"expected 3-D volume, got shape {vol.shape}")
    vol_b64 = base64.b64encode(
        np.ascontiguousarray(_to_uint8(vol)).tobytes()).decode()

    lab_expr = "null"
    lab_b64 = ""
    lut = {}
    if labels is not None:
        lab = np.asarray(labels)
        if lab.shape != vol.shape:
            raise ValueError(
                f"labels shape {lab.shape} != volume shape {vol.shape}")
        if roi_ids is not None:
            lab = np.where(np.isin(lab, list(roi_ids)), lab, 0)
        lab_b64 = base64.b64encode(
            np.ascontiguousarray(lab.astype("<u2")).tobytes()).decode()
        lab_expr = 'b64ToArr("__LAB__", Uint16Array)'
        lut = {int(k): str(v) for k, v in (roi_names_by_id or {}).items()}

    page = (_PAGE
            .replace("__TITLE__", _html.escape(title))
            .replace("__DIMS__", json.dumps([int(s) for s in vol.shape]))
            .replace("__SCALE__", "4" if max(vol.shape) < 64 else "2")
            .replace("__LUT__", json.dumps(lut))
            .replace("__LAB_EXPR__", lab_expr)
            .replace("__LAB__", lab_b64)
            .replace("__VOL__", vol_b64))
    with open(out_html, "w") as f:
        f.write(page)
    return out_html
