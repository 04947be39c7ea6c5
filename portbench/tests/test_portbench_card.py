"""On the card: one short run of each cell is correct, and the control
(the reference in bfloat16) at the same frames is not."""

import pytest

from portbench import checks, harness


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["tss.orbit", "pp.orbit",
                                      "tss.dirty_orbit"])
def test_a_short_run_is_correct_and_its_control_is_not(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    harness.set_cache_env()
    out = harness.run(workload, 31337, 2.0, False, control=True)
    assert out["correct"], out["checks"]
    assert (out["control"]["frame_off_gt1"]
            > checks.LIMITS["frame_off_gt1"])
