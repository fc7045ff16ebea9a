"""Rate control — CQ / ABR / two-pass bit allocation.

The reference delegates rate control to x264/x265 (encx264.c: 2-pass
stats file, `vbv`, CRF); this module is the engine-native equivalent
driving our encoders' per-frame QP. The model is the classic
qscale-domain one (x264 ratecontrol.c lineage):

    qscale = 2^((qp - 12) / 6)
    bits(frame) ~= complexity / qscale

Pass 1 measures complexity at fixed QP; pass 2 allocates
qscale_i = cplx_i^qcomp / rate_factor (qcomp 0.6 flattens quality across
easy/hard frames) with a feedback multiplier on accumulated error.
Single-pass ABR uses the same model with an EWMA complexity estimate.

Cross-pass state rides job.interjob (hb_interjob_t analog,
handbrake.h:122-136; correct_framerate work.c:870).
"""
from __future__ import annotations

import math
from typing import List, Optional

QCOMP = 0.6
I_QP_OFFSET = -3          # I frames coded finer (x264 ip_ratio analog)
MIN_QP, MAX_QP = 4, 51


def qp_to_qscale(qp: float) -> float:
    return 2.0 ** ((qp - 12.0) / 6.0)


def qscale_to_qp(qs: float) -> float:
    return 12.0 + 6.0 * math.log2(max(qs, 1e-9))


def estimate_start_qp(bitrate_kbps: float, width: int, height: int,
                      fps: float) -> int:
    """Initial QP from bits-per-pixel (x264 rate_estimate heuristic)."""
    bpp = bitrate_kbps * 1000.0 / max(1.0, fps * width * height)
    # empirical anchor: 0.1 bpp ~ qp 30 for our encoders; 6 qp per 2x rate
    qp = 30.0 - 6.0 * math.log2(max(bpp, 1e-6) / 0.1)
    return int(round(min(MAX_QP - 2, max(MIN_QP + 2, qp))))


class RateController:
    """Per-frame QP source + bit-usage feedback.

    mode: "cq" (constant QP), "abr" (single-pass average bitrate),
    "pass1" (analysis: fixed QP, records stats), "pass2" (allocate from
    pass-1 stats).
    """

    def __init__(self, mode: str, qp: int = 26,
                 bitrate_kbps: Optional[float] = None, fps: float = 30.0,
                 width: int = 0, height: int = 0,
                 stats: Optional[List[dict]] = None):
        self.mode = mode
        self.fps = max(1e-6, fps)
        self.bitrate = bitrate_kbps
        self.frame_idx = 0
        self.total_bits = 0
        self.stats: List[dict] = []          # pass-1 output
        self._last_qp = qp
        if mode == "cq":
            self.base_qp = qp
        elif mode in ("abr", "pass1"):
            self.base_qp = estimate_start_qp(bitrate_kbps, width, height,
                                             fps) if bitrate_kbps else qp
            self.target_bpf = (bitrate_kbps * 1000.0 / self.fps
                               if bitrate_kbps else None)
            # EWMA of qscale-normalized complexity
            self._cplx = None
        elif mode == "pass2":
            if not stats:
                raise ValueError("pass2 requires pass-1 stats")
            self.in_stats = stats
            self.target_bpf = bitrate_kbps * 1000.0 / self.fps
            total = self.target_bpf * len(stats)
            blurred = [max(1.0, s["cplx"]) ** QCOMP for s in stats]
            # rate_factor solving sum(bits_i) = total, where I frames run
            # I_QP_OFFSET finer (extra bits baked into the solve so the
            # offset does not bias the total)
            ioff = 2.0 ** (-I_QP_OFFSET / 6.0)
            denom = sum(max(1.0, s["cplx"]) / b * (ioff if s["idr"] else 1)
                        for s, b in zip(stats, blurred))
            self._rf = denom / max(1.0, total)
            self._blurred = blurred
            self._bias = 1.0      # online bits-model calibration
        else:
            raise ValueError(f"unknown rc mode {mode!r}")

    # -- per-frame -------------------------------------------------------------
    def frame_qp(self, is_idr: bool) -> int:
        if self.mode == "cq":
            return self.base_qp
        if self.mode == "pass1":
            return self.base_qp
        if self.mode == "abr":
            qp = self._abr_qp()
        else:
            qp = self._pass2_qp()
        if is_idr:
            qp += I_QP_OFFSET
        qp = int(round(min(MAX_QP, max(MIN_QP, qp))))
        # limit swing between consecutive frames (stability)
        qp = min(self._last_qp + 4, max(self._last_qp - 4, qp))
        self._last_qp = qp
        return qp

    def _abr_qp(self) -> float:
        if self._cplx is None or self.frame_idx == 0:
            return float(self.base_qp)
        # qscale that would hit the per-frame budget for current complexity
        want = self._cplx / max(1.0, self.target_bpf)
        qp = qscale_to_qp(want)
        # feedback: accumulated over/undershoot vs elapsed budget
        expected = self.target_bpf * self.frame_idx
        err = (self.total_bits - expected) / max(1.0, self.target_bpf)
        qp += min(6.0, max(-6.0, 0.5 * err))
        return qp

    def _pass2_qp(self) -> float:
        i = min(self.frame_idx, len(self.in_stats) - 1)
        s = self.in_stats[i]
        # bias-corrected model: real bits ~= bias * cplx / qscale, so the
        # qscale that lands on the planned allocation is bias * model qs.
        # The EWMA bias (updated from predicted-vs-actual each frame)
        # removes steady-state error that a proportional servo on the
        # cumulative ratio cannot (it needs a persistent offset to act).
        qs = max(1.0, s["cplx"]) ** QCOMP * self._rf * self._bias
        qp = qscale_to_qp(qs)
        if self.frame_idx > 0:
            # residual drift servo on the absolute target
            r = self.total_bits / (self.target_bpf * self.frame_idx)
            qp += min(3.0, max(-3.0, 2.0 * math.log2(max(r, 1e-6))))
        return qp

    def update(self, bits: int, qp: int, is_idr: bool):
        self.total_bits += bits
        cplx = bits * qp_to_qscale(qp)
        if self.mode == "pass1":
            self.stats.append({"bits": bits, "qp": qp,
                               "idr": bool(is_idr), "cplx": cplx})
        elif self.mode == "abr":
            self._cplx = (cplx if self._cplx is None
                          else 0.8 * self._cplx + 0.2 * cplx)
        elif self.mode == "pass2":
            i = min(self.frame_idx, len(self.in_stats) - 1)
            cx = max(1.0, self.in_stats[i]["cplx"])
            predicted = cx / qp_to_qscale(qp)   # un-biased model
            e = bits / max(1.0, predicted)
            self._bias = min(8.0, max(0.125,
                                      0.7 * self._bias + 0.3 * e))
        self.frame_idx += 1


def make_rate_controller(job, width: int, height: int,
                         vrate: float) -> RateController:
    """Build the controller a work pass needs (job schema §2.6: Video
    {Quality | Bitrate + MultiPass}; pass_id from hb_job_setup_passes)."""
    if job.vbitrate:
        if job.pass_id == 1:
            return RateController("pass1", bitrate_kbps=job.vbitrate,
                                  fps=vrate, width=width, height=height)
        if job.pass_id == 2:
            return RateController("pass2", bitrate_kbps=job.vbitrate,
                                  fps=vrate,
                                  stats=job.interjob.get("rc_stats"))
        return RateController("abr", bitrate_kbps=job.vbitrate, fps=vrate,
                              width=width, height=height)
    from ..work import quality_to_qp
    qp = quality_to_qp(job.quality if job.quality is not None else 26)
    return RateController("cq", qp=qp)
