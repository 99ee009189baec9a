"""The K4 lab's variants stay edits that apply to K4's source as it
stands."""

import pytest
import torch

from myrenderer_tpu_torch.ops import straddlers
from myrenderer_tpu_torch.tools import k4_lab


@pytest.fixture(scope="module")
def source():
    with open(straddlers._SOURCE) as f:
        return f.read()


@pytest.mark.parametrize("name", list(k4_lab.VARIANTS))
def test_variant_edits_apply(name, source):
    out = k4_lab.VARIANTS[name](source)
    assert (out == source) == (name == "source")
    assert "straddlers_launch" in out


def test_lab_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert k4_lab.main([]) == 1
