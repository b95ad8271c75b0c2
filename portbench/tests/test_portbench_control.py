"""The control at a size a test run holds: the reference in float8 put in
the program's place must come out not correct under the committed limits
(on the card it is read at the cells' own sizes by ``portbench.limits``)."""

import pytest

from portbench import limits
from portbench_tiny import cell, run


def _fails(c, got):
    lim = c.config["limits"][c.traffic["runner"]]
    return any(got[k] > v for k, v in lim.items())


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_float8_control_fails_serving(seed):
    c = cell("serve", dtype="bfloat16")
    assert _fails(c, limits.control(c, run(c, seed=seed), device="cpu"))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_float8_control_and_half_batch_fail_training(seed):
    c = cell("train", dtype="bfloat16")
    r = run(c, seed=seed)
    for kw in ({"lower": True}, {"lower": False, "half": True}):
        assert _fails(c, limits.control(c, r, device="cpu", **kw)), kw
