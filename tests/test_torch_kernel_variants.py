"""nart_tpu_torch/kernel_variants.py without a card: every variant's
substitutions still find their anchors in csrc/cluster_hit.cu (K1, K2),
csrc/bvh_walk.cu (B1), csrc/bsdf.cu (X1, X3) and csrc/vol_step.cu (V1,
V2), each exactly once, the shipped sources carry none of the measuring
code nor the steps measured and not taken, ptxas' report is read right,
and the BSDF rows' comparison reads bits.  (The variants are built and
timed on the card only.)
"""

import pytest
import torch

from nart_tpu_torch import kernel_variants as kv


def _shipped(kernel):
    """The kernel's source as shipped, after checking that the "as built"
    variant is that text."""
    with open(kv.KERNELS[kernel][0]) as f:
        shipped = f.read()
    assert kv.variant_sources(kernel)["as built"] == shipped
    return shipped


def _applies(kernel, name):
    """A variant's every substitution found its anchor exactly once (else
    variant_sources raises) and left balanced braces."""
    variants = kv.KERNELS[kernel][1]
    for old, _ in variants[name]:
        assert _shipped(kernel).count(old) == 1, old
    sources = kv.variant_sources(kernel)
    text = sources[name]
    assert text != sources["as built"]
    for _, new in variants[name]:
        assert new in text
    assert text.count("{") == text.count("}")


def test_as_built_is_the_shipped_source():
    shipped = _shipped("cluster")
    assert "g_zero" not in shipped and "NART_REPEAT" not in shipped


@pytest.mark.parametrize("name", [k for k in kv.VARIANTS if k != "as built"])
def test_variant_applies_to_the_source(name):
    _applies("cluster", name)


def test_bvh_as_built_is_the_shipped_source():
    _shipped("bvh")


@pytest.mark.parametrize("name", [k for k in kv.BVH_VARIANTS
                                  if k != "as built"])
def test_bvh_variant_applies_to_the_source(name):
    _applies("bvh", name)


def test_bsdf_as_built_is_the_shipped_source():
    shipped = _shipped("bsdf")
    for k, v in kv.BSDF_AS_BUILT.items():
        assert f" {k} = {v};" in shipped
    assert "Regroup" not in shipped and "kPasses" not in shipped


@pytest.mark.parametrize("name", [k for k in kv.BSDF_VARIANTS
                                  if k != "as built"])
def test_bsdf_variant_applies_to_the_source(name):
    _applies("bsdf", name)
    assert "first design" in kv.BSDF_VARIANTS


def test_vol_as_built_is_the_shipped_source():
    """csrc/vol_step.cu's redesign switches as VOL_AS_BUILT says, the
    first designs' entries beside the redesign's, and the host walk
    outside the nvcc build."""
    shipped = _shipped("vol")
    for k, v in kv.VOL_AS_BUILT.items():
        assert f"constexpr bool {k} = {v};" in shipped
    for entry in ("int nart_vol_steps(", "int nart_vol_steps_bwd(",
                  "int nart_vol_steps_ref(", "int nart_vol_steps_bwd_ref(",
                  "int nart_vol_host_walk("):
        assert shipped.count(entry) == 1, entry
    assert shipped.index("#else  // the host walk") < shipped.index(
        "int nart_vol_host_walk(")


@pytest.mark.parametrize("name", [k for k in kv.VOL_VARIANTS
                                  if k != "as built"])
def test_vol_variant_applies_to_the_source(name):
    _applies("vol", name)
    assert {"steps off", "32 threads", "64 threads"} <= set(kv.VOL_VARIANTS)


def test_bsdf_same_reads_bits():
    x = torch.tensor([0.0, 1.0, -2.5, 3.0])
    y = torch.tensor([-0.0, 1.0, -2.5, 3.0000003])
    flags = torch.tensor([1, 2], dtype=torch.int64)
    assert kv.bsdf_same("X1 macbeth", (x, flags),
                        (x.clone(), flags.clone())) == (True, 1.0)
    assert kv.bsdf_same("X1 macbeth", (x,), (y,)) == (False, 0.0)
    assert kv.bsdf_same("X3s macbeth", (x,), (y,)) == (True, 0.5)
    assert not kv.bsdf_same("X3e glossy", (x,), (x + 1e-3,))[0]


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


def test_bsdf_sample_eval_row_builds_from_the_shipped_source():
    """The "X1 + X2" against "sample+eval" row (the "SE" cases): the
    shipped source and every variant of it carry the sample+eval launch's
    entry and kernel beside X1's and X2's, so every variant's library
    times it."""
    for name, text in kv.variant_sources("bsdf").items():
        for entry in ("int nart_bsdf_sample_eval(", "int nart_bsdf_sample(",
                      "int nart_bsdf_eval(", "bsdf_sample_eval_kernel<"):
            assert text.count(entry) == 1, (name, entry)


def test_bsdf_sample_eval_cases_are_wired(monkeypatch):
    """bsdf_cases' "SE" case on CPU tensors, the wrappers standing in by
    their plain versions (the kernels run on the card only): its
    reference (X1 then X2, two calls) and its new call (the sample+eval
    wrapper) take the same lanes and the same eval direction, nine
    outputs each, the same bits; the X1 and X2 cases still there."""
    from nart_tpu_torch import bsdf_ops, testing

    def bits_of(out):
        return torch.zeros(out[0].shape[0], dtype=torch.int32)

    def sample(*a):
        out = bsdf_ops.sample_plain(*a)
        return (*out, bits_of(out))

    def sample_eval(*a):
        out = bsdf_ops.sample_eval_plain(*a)
        return (*out[:6], bits_of(out), *out[6:])

    for name, fn in (("sample_cuda", sample), ("sample_ref_cuda", sample),
                     ("eval_cuda", bsdf_ops.eval_plain),
                     ("sample_eval_cuda", sample_eval),
                     ("f_bwd_cuda", lambda *a, **k: ()),
                     ("f_bwd_ref_cuda", lambda *a, **k: ())):
        monkeypatch.setattr(bsdf_ops, name, fn)
    s = testing.bsdf_lane_set("plastic", 256, 0, "cpu")
    sample_s, eval_s = testing.split_sample_eval(
        dict(s, wi_b=torch.flip(s["wi"], (0,))))
    cases = kv.bsdf_cases({"glossy": (s, s), "macbeth": (sample_s, eval_s)})
    for label in ("glossy", "macbeth"):
        assert {f"{k} {label}" for k in ("X1", "X2", "X3s", "X3e", "SE")} <= (
            set(cases))
        ref = cases[f"SE {label}"](reference=True)
        new = cases[f"SE {label}"](reference=False)
        assert len(ref) == len(new) == 9
        assert kv.bsdf_same(f"SE {label}", new, ref) == (True, 1.0)
    e = eval_s
    assert torch.equal(cases["SE macbeth"]()[7], bsdf_ops.eval_plain(
        e["desc"], e["wo"], e["wi"], e["use_prime"], e["eta_outer"])[0])
