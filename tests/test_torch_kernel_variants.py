"""nart_tpu_torch/kernel_variants.py without a card: every variant's
substitutions still find their anchors in csrc/cluster_hit.cu (K1, K2)
and csrc/bvh_walk.cu (B1), the shipped sources carry none of the
measuring code, and ptxas' report is read right.  (The variants are built
and timed on the card only.)
"""

import pytest
import torch

from nart_tpu_torch import kernel_variants as kv


def test_as_built_is_the_shipped_source():
    with open(kv.SOURCE) as f:
        shipped = f.read()
    assert kv.variant_sources()["as built"] == shipped
    assert "g_zero" not in shipped and "NART_REPEAT" not in shipped


@pytest.mark.parametrize("name", [k for k in kv.VARIANTS if k != "as built"])
def test_variant_applies_to_the_source(name):
    sources = kv.variant_sources()
    text = sources[name]
    assert text != sources["as built"]
    for _, new in kv.VARIANTS[name]:
        assert new in text
    assert text.count("{") == text.count("}")


def test_bvh_as_built_is_the_shipped_source():
    with open(kv.BVH_SOURCE) as f:
        shipped = f.read()
    assert kv.variant_sources("bvh")["as built"] == shipped


@pytest.mark.parametrize("name", [k for k in kv.BVH_VARIANTS
                                  if k != "as built"])
def test_bvh_variant_applies_to_the_source(name):
    sources = kv.variant_sources("bvh")
    text = sources[name]
    assert text != sources["as built"]
    for _, new in kv.BVH_VARIANTS[name]:
        assert new in text
    assert text.count("{") == text.count("}")


def test_outdated_anchor_raises(monkeypatch):
    monkeypatch.setitem(kv.VARIANTS, "stale", [("no such line", "x")])
    with pytest.raises(ValueError, match="anchor found 0 times"):
        kv.variant_sources()


def test_ptxas_report_is_parsed():
    report = """\
ptxas info    : Compiling entry function '_ZN3foo11walk_kernelILi4ELb0ELb1EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN3foo11walk_kernelILi4ELb0ELb1EEEvPKf
    80 bytes stack frame, 96 bytes spill stores, 132 bytes spill loads
ptxas info    : Used 128 registers, used 0 barriers, 80 bytes cumulative stack size, 6144 bytes smem
ptxas info    : Compiling entry function '_ZN3foo11walk_kernelILi1ELb1ELb0EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN3foo11walk_kernelILi1ELb1ELb0EEEvPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 54 registers, used 0 barriers, 6144 bytes smem
"""
    assert kv.ptxas_kernels(report) == [
        ("_ZN3foo11walk_kernelILi1ELb1ELb0EEEvPKf", 54, 0, 0, 0),
        ("_ZN3foo11walk_kernelILi4ELb0ELb1EEEvPKf", 128, 80, 96, 132)]


def test_main_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kv.main([])
