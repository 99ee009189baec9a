"""The K5 lab's variants stay edits that apply to K5's source as it
stands."""

import pytest
import torch

from myrenderer_tpu_torch.ops import binning
from myrenderer_tpu_torch.tools import k5_lab


@pytest.fixture(scope="module")
def source():
    with open(binning._SOURCE) as f:
        return f.read()


@pytest.mark.parametrize("name", list(k5_lab.VARIANTS))
def test_variant_edits_apply(name, source):
    out = k5_lab.VARIANTS[name](source)
    assert (out == source) == (name == "source")
    assert "bin_tiles_launch" in out


def test_lab_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert k5_lab.main([]) == 1
