"""The hqdn3d kernel's division by 255 (``csrc/hqdn3d.cu`` ``div255``),
checked on the CPU: the product by r = RN(1/255) with one fma
correction, q = RN(a r), q' = fma(fma(-q, 255, a), r, q), against
numpy's IEEE f32 division.  The fma is ``utils/fp.fma32`` (exact in
float64).  Also the ablation tool's variants.

Scaling a by a power of 2 scales every step exactly while q = RN(a r) is
normal: the residual a - 255 q is a multiple of ulp(q) below 2^8 ulp(q),
so the first fma gives it exactly even where it is subnormal, and the
second fma and the IEEE quotient round exact values that scale with a.
So one binade, [1, 2), stands for every a from 2^-117 up.  Every value
below 2^-100 is checked as well: there the quotient (below 2^-117) or the
residual (up to 2^-100) is subnormal.  The card checks every f32 in
[0, 256) against ``__fdiv_rn`` (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 6 (b)).
"""
import re

import numpy as np
import pytest
import torch

from handbrake_tpu_torch.filters import hqdn3d_cuda
from handbrake_tpu_torch.utils.fp import fma32

R = np.float32(1.0) / np.float32(255.0)
CHUNK = 1 << 22


def _bits(x: float) -> int:
    return int(np.float32(x).view(np.uint32))


def _mismatches(bits: np.ndarray) -> np.ndarray:
    """The bit patterns whose formula quotient differs from a / 255."""
    a = bits.view(np.float32)
    q = a * R
    at, qt = torch.from_numpy(a), torch.from_numpy(q)
    got = fma32(fma32(-qt, torch.tensor(np.float32(255.0)), at),
                torch.tensor(R), qt).numpy()
    want = a / np.float32(255.0)
    return bits[got.view(np.uint32) != want.view(np.uint32)]


def _check_range(lo: int, hi: int) -> int:
    bad = 0
    for s in range(lo, hi, CHUNK):
        bad += _mismatches(np.arange(s, min(s + CHUNK, hi),
                                     dtype=np.uint32)).size
    return bad


def test_kernel_uses_rn_reciprocal():
    """The source's constant is RN(1/255) and the kernel divides with it."""
    with open(hqdn3d_cuda.SOURCE) as f:
        src = f.read()
    lits = re.findall(r"(0x1\.[0-9a-f]+p-8)f;\s*// RN\(1/255\)", src)
    assert lits and float.fromhex(lits[0]) == float(R)
    assert "#define HQDN3D_IEEE_DIV 0" in src


@pytest.mark.parametrize("lo,hi", [(1.0, 2.0), (128.0, 256.0),
                                   (0.0, 2.0 ** -100)],
                         ids=["binade-1", "binade-128", "subnormal-quotients"])
def test_division_exact_on_range(lo, hi):
    """Every f32 in [lo, hi)."""
    assert _check_range(_bits(lo), _bits(hi)) == 0


def test_division_exact_on_random_values():
    """10^6 bit patterns drawn uniformly from [0, 256)'s: every binade,
    subnormals included; the product alone is wrong on most of them."""
    bits = np.random.default_rng(255).integers(
        0, hqdn3d_cuda.DIV_CHECK_END, 10 ** 6, dtype=np.uint32)
    a = bits.view(np.float32)
    assert (a < np.finfo(np.float32).tiny).sum() > 1000
    assert (a * R != a / np.float32(255.0)).mean() > 0.5
    assert _mismatches(bits).size == 0


def test_ablation_switches_apply():
    """Every variant of ``tools/ablate_hqdn3d.py`` sets switches that
    the kernel's source reads, ahead of the source as it is, or is one
    that ``hqdn3d_ablate.cu`` launches, with the kernel's source."""
    from handbrake_tpu_torch.tools import ablate_hqdn3d as ab
    with open(hqdn3d_cuda.SOURCE) as f:
        src = f.read()
    files = ab.ablation_sources(src)
    assert files["hqdn3d.cu"] == src
    for sw, _, exact in ab.VARIANTS.values():
        if isinstance(sw, dict):
            assert ab.variant_source(src, sw).endswith(src)
        else:
            assert exact and f"variant == {sw}" in files["hqdn3d_ablate.cu"]
    with pytest.raises(RuntimeError):
        ab.variant_source(src, {"HQDN3D_NO_SUCH_SWITCH": 1})
