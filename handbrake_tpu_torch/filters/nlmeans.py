"""NLMeans denoiser (reference: nlmeans.c) — the counterpart of
``handbrake_tpu/filters/nlmeans.py``.

For every search offset (dx, dy) the patch SSD for all pixels at once is
a box filter over the squared difference plane (two separable ones-sums),
then w = exp(-ssd / (h^2 * npix)).  Offsets and frames are walked in the
reference's order, so the f32 sums accumulate in the same order; the
temporal search runs the same loop against a ring of previous frames
(y_frame_count) kept on the filter's device.  Torch operations: about
20 a search offset and plane.

Settings (param.c table names): {y,cb}_strength, _origin_tune, _patch_size,
_range, _frame_count.  ``tile_parallel`` N cuts each plane into row
tiles over min(N, ranks) ranks of the process group
(``parallel/mesh.py`` ``tile_shard_nlmeans``: each rank filters its tile
with rng + patch rows of its neighbours, and the output equals the
untiled filter bit for bit); a plane too small for the halo, or a job on
one rank, runs untiled.
"""
from __future__ import annotations

import torch

from ..core.buffer import Buffer
from ..job import schema as S
from ..utils.device import resolve_device
from ..utils.logging import log
from .base import Filter, FilterInit, register
from .kernels import div, out_dtype, pad_edge, shift2, to_tensor


def _box(a: torch.Tensor, size: int) -> torch.Tensor:
    """Separable ones-filter (patch sum), edge replicate, summed in the
    reference's order."""
    p = size // 2
    h, w = a.shape
    ap = pad_edge(a, p, p, 0, 0)
    v = ap[0:h]
    for i in range(1, size):
        v = v + ap[i:i + h]
    vp = pad_edge(v, 0, 0, p, p)
    out = vp[:, 0:w]
    for i in range(1, size):
        out = out + vp[:, i:i + w]
    return out


def nlmeans_plane(cur: torch.Tensor, refs: torch.Tensor,
                  strength: float = 6.0, origin_tune: float = 0.9,
                  patch: int = 7, rng: int = 3, maxval: int = 255
                  ) -> torch.Tensor:
    """cur: (H, W) integer tensor; refs: (T, H, W) search planes
    (refs[0] == cur), on cur's device."""
    x = cur.to(torch.float32)
    h2npix = (strength * strength) * (patch * patch)
    acc = x * origin_tune
    wsum = torch.full_like(x, origin_tune)
    for t in range(refs.shape[0]):
        r = refs[t].to(torch.float32)
        for dy in range(-rng, rng + 1):
            for dx in range(-rng, rng + 1):
                if t == 0 and dy == 0 and dx == 0:
                    continue  # origin handled above
                s = shift2(r, dy, dx)
                ssd = _box((x - s) ** 2, patch)
                w = torch.exp(div(-ssd, h2npix))
                acc = acc + w * s
                wsum = wsum + w
    out = acc / wsum
    return torch.clamp(torch.round(out), 0, maxval).to(out_dtype(maxval))


@register
class NLMeansFilter(Filter):
    id = S.FILTER_NLMEANS
    name = "nlmeans"

    def init(self, fi: FilterInit) -> FilterInit:
        s = self.settings
        scale = float(s.get("y_strength_scale", 1.0))
        fc = int(s.get("frame_count", s.get("y_frame_count", 2)))
        self.y = dict(strength=float(s.get("y_strength", 6.0)) * scale,
                      origin_tune=float(s.get("y_origin_tune", 0.9)),
                      patch=int(s.get("y_patch_size", 7)),
                      rng=int(s.get("y_range", 3)),
                      frames=max(1, fc))
        self.c = dict(strength=float(s.get("cb_strength",
                                           self.y["strength"])),
                      origin_tune=float(s.get("cb_origin_tune",
                                              self.y["origin_tune"])),
                      patch=int(s.get("cb_patch_size", 7)),
                      rng=int(s.get("cb_range", 3)),
                      frames=max(1, int(s.get("cb_frame_count", fc))))
        self.hist: list = []  # ring of previous frames' planes
        self.maxval = (1 << fi.pix_fmt.bit_depth) - 1
        self.device = resolve_device(fi.device)
        self._tiles = int(s.get("tile_parallel", 0) or 0)
        self._tile_fns: dict = {}
        self._mesh = None
        if self._tiles > 1:
            from ..parallel.mesh import current_world, make_mesh
            w = current_world()
            n = min(self._tiles, w.size) if w is not None else 1
            if n > 1:
                self._mesh = make_mesh(n, tile=n, device=self.device)
            log(f"nlmeans: tile_parallel={self._tiles}: "
                + (f"{n} row tiles over {n} ranks (slower than the "
                   f"untiled filter in every run on H100s so far: "
                   f"PERF.md, ROADMAP.md)" if n > 1
                   else "one rank, untiled"))
        self.fi = fi.copy()
        return self.fi

    def keeps_state(self):
        """Frame-local with one frame a plane; its temporal frames are a
        ring of the frames before."""
        n = max(self.y["frames"], self.c["frames"])
        return None if n == 1 else (f"keeps state across frames ({n} "
                                    f"temporal frames)")

    def _plane_fn(self, cfg):
        """The filter of one plane: tiled over the mesh, or untiled."""
        kw = dict(strength=cfg["strength"], origin_tune=cfg["origin_tune"],
                  patch=cfg["patch"], rng=cfg["rng"], maxval=self.maxval)
        if self._mesh is None:
            return lambda cur, refs: nlmeans_plane(cur, refs, **kw)
        key = tuple(kw.values())
        if key not in self._tile_fns:
            from ..parallel.mesh import tile_shard_nlmeans
            self._tile_fns[key] = tile_shard_nlmeans(self._mesh, **kw)
        return self._tile_fns[key]

    def work(self, buf: Buffer) -> list:
        if buf.is_eof() or buf.planes is None:
            return [buf]
        maxframes = max(self.y["frames"], self.c["frames"])
        cur = [to_tensor(p, self.device) for p in buf.planes]
        planes = []
        for i, pj in enumerate(cur):
            cfg = self.y if i == 0 else self.c
            if cfg["strength"] <= 0:
                planes.append(pj)
                continue
            past = [h[i] for h in self.hist[-(cfg["frames"] - 1):]] \
                if cfg["frames"] > 1 else []
            refs = torch.stack([pj] + past)
            planes.append(self._plane_fn(cfg)(pj, refs))
        self.hist.append(cur)
        if len(self.hist) >= maxframes:
            self.hist = self.hist[-(maxframes - 1):] if maxframes > 1 else []
        return [Buffer(planes=planes, pix_fmt=buf.pix_fmt).copy_props(buf)]
