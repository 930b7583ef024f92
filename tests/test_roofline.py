"""Roofline accounting math (utils/roofline.py)."""

import pytest

from otto_tpu.utils.roofline import PEAKS, chip_peaks, roofline


class Card:
    def __init__(self, kind):
        self.device_kind = kind


H100 = Card("NVIDIA H100 80GB HBM3")


def test_roofline_fractions():
    # 3350 GB moved in 2 s on an H100 = 1675 GB/s = 0.5 of peak
    r = roofline(2.0, hbm_bytes=3350e9, device=H100)
    assert r["hbm_gbps"] == 1675.0
    assert abs(r["hbm_frac"] - 0.5) < 1e-6
    assert r["bound"] == "hbm"

    # 989 TFLOP of bf16 work in 2 s = half the tensor-core peak
    r = roofline(2.0, bf16_flops=989e12, device=H100)
    assert abs(r["tc_frac"] - 0.5) < 1e-6
    assert r["bound"] == "tensor"

    # f32 (TF32) flops compare against the TF32 peak
    r = roofline(1.0, f32_flops=495e12, device=H100)
    assert abs(r["tc_frac"] - 1.0) < 1e-6


def test_chip_peaks_h100_lookup():
    p = chip_peaks(H100)
    assert p == PEAKS["NVIDIA H100 80GB HBM3"]
    assert (p.hbm_gbps, p.bf16_tflops, p.f32_tflops) == (3350.0, 989.0, 495.0)


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", None])
def test_chip_peaks_unknown_kind_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        chip_peaks(Card(kind))
    with pytest.raises(KeyError):
        roofline(1.0, hbm_bytes=1.0, device=Card(kind))
