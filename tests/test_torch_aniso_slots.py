"""The tiered anisotropic sampler's kernel wrapper on the CPU
(``sampling.aniso_slots``; the kernel, ``csrc/aniso_slots.cu``, runs only
on a card, where ``tests/test_torch_gpu.py`` holds it to the plain
version bit for bit): on CPU tensors the wrapper returns the plain
version's result unchanged, ``sample_slots_aniso_tiered`` hands it views
made contiguous, and the argument checks refuse what the kernel does not
take before any launch, on every device.

Tolerance, stated: none; the CPU path is the plain version itself."""

import pytest
import torch

import aniso_inputs as ai
from renderengine_tpu_torch.raster import cuda_raster as cr
from renderengine_tpu_torch.shading import sampling

torch.set_num_threads(2)

# (spec, slots used): the default ladder, every segment selected, and a
# two-tier 8x ladder over three slots (one slot no material uses)
SPECS = {"default": (ai.DEFAULT_SPEC, (0, 1, 2, 3)),
         "all_selected": (sampling.AnisoSpec(16, (1.0, 1.0, 1.0)),
                          (0, 1, 2, 3)),
         "two_tiers": (sampling.AnisoSpec(8, (0.5, 0.25), (8, 1, 2, 4)),
                       (0, 2, 3))}


def caps_of(spec, used):
    """The per-slot caps ``pbr.remap_material`` passes for ``used``."""
    return None if not spec.slot_caps else [spec.slot_caps[s] for s in used]


@pytest.mark.parametrize("words", [4, 8], ids=["u8", "u16"])
@pytest.mark.parametrize("spec", list(SPECS), ids=list(SPECS))
def test_wrapper_on_cpu_is_the_plain_version(words, spec):
    spec, used = SPECS[spec]
    args = ai.case(5 + words, 24, 200, words=words, used=used)
    caps = caps_of(spec, used)
    before = dict(cr.launch_counts)
    got = sampling.aniso_slots(*args, spec, slot_caps=caps, seg_w=32)
    want = sampling.sample_slots_aniso_tiered_plain(*args, spec,
                                                    slot_caps=caps, seg_w=32)
    assert dict(cr.launch_counts) == before        # the CPU launches nothing
    assert len(got) == len(used)
    for a, b in zip(got, want):
        assert a.shape == (24, 200, 4)
        assert torch.equal(a, b)


def test_tiered_sampler_takes_views():
    """``sample_slots_aniso_tiered`` accepts the fragment's uv as a view
    of its attribute planes (the frame's case) and gives the plain
    version's result."""
    atlas, mip_y, mip_x, sl, uv, dx, dy = ai.case(3, 16, 96)
    attrs = torch.cat([torch.zeros(16, 96, 6), uv], -1)
    view = attrs[..., 6:8]
    assert not view.is_contiguous()
    got = sampling.sample_slots_aniso_tiered(
        atlas, mip_y, mip_x, sl, view, dx, dy, ai.DEFAULT_SPEC,
        slot_caps=list(ai.DEFAULT_SPEC.slot_caps), seg_w=32)
    want = sampling.sample_slots_aniso_tiered_plain(
        atlas, mip_y, mip_x, sl, uv, dx, dy, ai.DEFAULT_SPEC,
        slot_caps=list(ai.DEFAULT_SPEC.slot_caps), seg_w=32)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _bad(kind, args):
    atlas, mip_y, mip_x, sl, uv, dx, dy = args
    tex0, nm0 = sl[0]
    if kind == "float_plane":
        sl = [({**tex0, "w": tex0["w"].float()}, nm0)] + sl[1:]
    elif kind == "int_uv":
        uv = uv.to(torch.int32)
    elif kind == "u64_atlas":
        atlas = atlas.to(torch.int64)
    elif kind == "strided_plane":
        x = torch.stack([tex0["x"], tex0["x"]], -1)[..., 0]
        assert not x.is_contiguous()
        sl = [({**tex0, "x": x}, nm0)] + sl[1:]
    elif kind == "strided_uv":
        uv = uv.transpose(0, 1).contiguous().transpose(0, 1)
    elif kind == "short_plane":
        sl = [({**tex0, "page": tex0["page"][:-1]}, nm0)] + sl[1:]
    elif kind == "short_derivs":
        dx = dx[:, :-1].contiguous()
    elif kind == "flat_uv":
        uv = uv[..., 0].contiguous()
    elif kind == "five_slots":
        sl = sl + sl[:1]
    elif kind == "atlas_words":
        atlas = atlas[..., :2].contiguous()
    return atlas, mip_y, mip_x, sl, uv, dx, dy


@pytest.mark.parametrize("kind", [
    "float_plane", "int_uv", "u64_atlas", "strided_plane", "strided_uv",
    "short_plane", "short_derivs", "flat_uv", "five_slots", "atlas_words"])
def test_wrapper_refuses_bad_arguments(kind, monkeypatch):
    """A wrong dtype, a non-contiguous input or a mismatched shape raises
    before anything runs: neither the plain version nor the library is
    reached."""
    def reached(*a, **k):
        raise AssertionError("reached past the checks")
    monkeypatch.setattr(sampling, "sample_slots_aniso_tiered_plain", reached)
    monkeypatch.setattr(cr, "_library", reached)
    args = _bad(kind, ai.case(4, 8, 40))
    with pytest.raises((TypeError, ValueError)):
        sampling.aniso_slots(*args, ai.DEFAULT_SPEC)
