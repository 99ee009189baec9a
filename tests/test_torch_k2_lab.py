"""The K2 lab's variants stay edits that apply to K2's source as it
stands."""

import pytest
import torch

from myrenderer_tpu_torch.ops import setup_pack
from myrenderer_tpu_torch.tools import k2_lab


@pytest.fixture(scope="module")
def source():
    with open(setup_pack._SOURCE) as f:
        return f.read()


@pytest.mark.parametrize("name", list(k2_lab.VARIANTS))
def test_variant_edits_apply(name, source):
    out = k2_lab.VARIANTS[name](source)
    assert (out == source) == (name == "source")
    assert "setup_pack_launch" in out


def test_lab_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert k2_lab.main([]) == 1
