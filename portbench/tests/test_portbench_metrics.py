"""The per-layer readers on readings made by hand."""

import pytest

from portbench import harness, peaks
from portbench.kernels import k1, k2

K1_OPAQUE = "void (anonymous namespace)::raster_tile_kernel<8, false, false>(x)"
K1_PEEL = "void (anonymous namespace)::raster_tile_kernel<8, true, true>(x)"
K1_SHADOW = "void (anonymous namespace)::raster_tile_kernel<0, false, false>(x)"
K2_NAME = "void (anonymous namespace)::merged_tile_kernel<2>(x)"


def _passes():
    one = {"pixels": 1000, "shadow_pixels": 4000,
           "opaque": {"fragments": 3000, "wins": 900, "triangles": 50},
           "blend": {"fragments": 400, "wins": [200, 50], "triangles": 4},
           "shadow": [{"fragments": 8000, "wins": 3000, "triangles": 60},
                      {"fragments": 6000, "wins": 2000, "triangles": 40}]}
    return [one, one]


def _read(name, readings):
    return harness.load_module("metrics", name).read(readings)


def test_k1_roofline_is_bounds_over_device_time():
    t = {"raster": [(K1_OPAQUE, 1e-6), (K1_PEEL, 2e-6), (K1_SHADOW, 3e-6),
                    (K2_NAME, 9.0)]}
    got = _read("k1_roofline", {"trace": t, "passes": _passes()})
    p = _passes()[0]
    b = (peaks.bound_s(*k1.work(8, False, False, 3000, 900, 50, 1000))
         + peaks.bound_s(*k1.work(8, True, True, 400, 250, 4, 1000))
         + peaks.bound_s(*k1.work(0, False, False, 7000, 2500, 50,
                                  p["shadow_pixels"])))
    assert got == pytest.approx(100 * b / 6e-6)


def test_k2_roofline_and_silence_without_records():
    t = {"raster": [(K2_NAME, 4e-6), (K2_NAME, 6e-6)]}
    got = _read("k2_roofline", {"trace": t, "passes": _passes()})
    p = _passes()[0]
    blend = dict(p["blend"], wins=250)
    b = peaks.bound_s(*k2.work(2, p["opaque"], blend, 1000))
    assert got == pytest.approx(100 * 2 * b / 1e-5)
    assert _read("k2_roofline", {"trace": {"raster": [(K1_OPAQUE, 1.0)]},
                                 "passes": _passes()}) is None
    assert _read("k1_roofline", {"trace": {"raster": [(K2_NAME, 1.0)]},
                                 "passes": _passes()}) is None


def test_device_and_loop_readers():
    tr = {"window_s": 2.0, "busy_s": 1.5, "kernels": 300, "frames": 10,
          "spans": {"frame.shade": 3.0, "frame.peel_shade": 1.0,
                    "frame.mask": 0.0, "frame.tss_spec": 0.5,
                    "frame.setup": 0.25, "frame.bin_pack": 0.5,
                    "frame.shadow": 0.0, "frame.tss_bake": 0.0}}
    rd = {"trace": tr, "render_ms": [1.0, 2.0, 3.0],
          "window": {"recaptures": 2}}
    assert _read("device.idle_share", rd) == pytest.approx(25.0)
    assert _read("device.kernels_per_frame", rd) == 30
    assert _read("shading.device_ms", rd) == pytest.approx(4.5)
    assert _read("binning.device_ms", rd) == pytest.approx(0.75)
    assert _read("shadow.device_ms", rd) is None
    assert _read("loop.render_call_ms", rd) == pytest.approx(2.0)
    assert _read("controller.recaptures", rd) == 2


def test_a_bound_is_the_larger_of_its_two_times():
    assert peaks.bound_s(67e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)
    ops, nbytes = k1.work(0, False, False, 10, 5, 1, 100)
    assert ops == 10 * 31 + 5 * (2 + 4 + 2) + 100 * (3 + 2)
    assert nbytes == 1 * 17 * 4 + (3 + 2) * 4 * 100
