"""The port keeps its own copies of the JAX package's jax-free host
modules (tables, bitstream syntax, transform constants, the native C++
slice coder).  Each copy must equal its original."""
import filecmp
import os

import numpy as np
import pytest

import handbrake_tpu
import handbrake_tpu_torch
from handbrake_tpu.codecs.h264 import bits as jbits
from handbrake_tpu.codecs.h264 import syntax as jsyntax
from handbrake_tpu.codecs.h264 import tables as jtables
from handbrake_tpu.codecs.h264 import transform as jtransform
from handbrake_tpu.native import gen_tables as jgen
from handbrake_tpu_torch.codecs.h264 import bits as tbits
from handbrake_tpu_torch.codecs.h264 import syntax as tsyntax
from handbrake_tpu_torch.codecs.h264 import tables as ttables
from handbrake_tpu_torch.codecs.h264 import transform as ttransform
from handbrake_tpu_torch.native import gen_tables as tgen


def _equal(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and \
            np.array_equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and \
            all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and \
            all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def _data(mod):
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("__")
            and isinstance(v, (np.ndarray, dict, list, tuple, int, float))}


@pytest.mark.parametrize("port,ref", [(ttables, jtables), (tbits, jbits),
                                      (tsyntax, jsyntax),
                                      (ttransform, jtransform)],
                         ids=["tables", "bits", "syntax", "transform"])
def test_module_constants_match(port, ref):
    a, b = _data(port), _data(ref)
    assert a.keys() == b.keys()
    for k in a:
        assert _equal(a[k], b[k]), k


def test_chroma_qp_matches():
    for qp in range(52):
        for off in range(-12, 13):
            assert ttransform.chroma_qp(qp, off) == \
                jtransform.chroma_qp(qp, off)


def test_generated_cavlc_tables_match():
    assert tgen.generate() == jgen.generate()


@pytest.mark.parametrize("name", ["hb264.cpp", "cabac264.h",
                                  "cabac_tables_h264.h"])
def test_native_sources_match(name):
    a = os.path.join(os.path.dirname(handbrake_tpu_torch.__file__),
                     "native", name)
    b = os.path.join(os.path.dirname(handbrake_tpu.__file__), "native", name)
    assert filecmp.cmp(a, b, shallow=False)
