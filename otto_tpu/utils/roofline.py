"""Roofline accounting: what fraction of the card's published peaks a
measured kernel achieves (SURVEY §7 M6 — per-kernel roofline checks).

Peaks are per card, keyed by ``device_kind``.  The byte/FLOP counts are the
*caller's* model of the kernel (documented at each call site); fractions are
therefore estimates of the achieved-vs-peak ratio under that model, not
hardware counters — use ``jax.profiler`` traces when exact numbers matter.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ChipPeaks:
    hbm_gbps: float  # device-memory bandwidth, GB/s
    bf16_tflops: float  # tensor-core peak, bf16 inputs / f32 accumulate, dense
    f32_tflops: float  # tensor-core peak with f32 inputs (TF32), dense


# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": ChipPeaks(hbm_gbps=3350.0, bf16_tflops=989.0,
                                       f32_tflops=495.0),
}


def chip_peaks(device) -> ChipPeaks:
    """Peaks of ``device`` (a jax device) by its ``device_kind``; a kind
    missing from :data:`PEAKS` is an error, never a default."""
    kind = getattr(device, "device_kind", None)
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"known: {sorted(PEAKS)}")
    return PEAKS[kind]


def roofline(seconds: float, *, device, hbm_bytes: float = 0.0,
             bf16_flops: float = 0.0, f32_flops: float = 0.0) -> dict:
    """Achieved rates and fractions-of-peak for one measured kernel call.

    Returns {"hbm_gbps", "hbm_frac", "tflops", "tc_frac", "bound"} — the
    binding resource is whichever fraction is highest (a kernel below ~0.5
    on both is latency-bound or under-shaped for the hardware).
    """
    peaks = chip_peaks(device)
    out: dict = {}
    hbm = hbm_bytes / seconds / 1e9 if seconds > 0 else 0.0
    out["hbm_gbps"] = round(hbm, 1)
    out["hbm_frac"] = round(hbm / peaks.hbm_gbps, 4)
    tflops = (bf16_flops + f32_flops) / seconds / 1e12 if seconds > 0 else 0.0
    peak_t = peaks.bf16_tflops if bf16_flops >= f32_flops else peaks.f32_tflops
    out["tflops"] = round(tflops, 2)
    out["tc_frac"] = round(tflops / peak_t, 4)
    out["bound"] = "hbm" if out["hbm_frac"] >= out["tc_frac"] else "tensor"
    return out
