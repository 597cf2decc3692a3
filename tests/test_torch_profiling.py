"""``davo_tpu_torch/utils/profiling.py`` on the CPU (the JAX module's
counterparts are ``jax.profiler`` and ``jax_debug_nans``, so the test
checks behaviour, not values):

* ``trace`` writes a Chrome trace naming the operators the block ran;
* ``timed`` runs a warm-up and ``repeats`` timed calls, returning the
  best time and the last result;
* ``debug_nans`` raises on the first operator whose floating output holds
  a NaN, forward or backward, names it, and checks nothing when disabled
  or outside its block.
"""

import json

import pytest
import torch

from davo_tpu_torch.utils import debug_nans, timed, trace
from tests.torch_port_helpers import torch_single_thread  # noqa: F401


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(16, 16)
    with trace(str(tmp_path)) as prof:
        torch.mm(a, a).sum()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(row.key == "aten::mm" for row in prof.key_averages())


def test_timed_best_of_repeats():
    calls = []

    def fn(x, scale=1.0):
        calls.append(x)
        return x * scale

    seconds, result = timed(fn, torch.ones(3), repeats=4, scale=2.0)
    assert len(calls) == 5 and seconds >= 0.0
    torch.testing.assert_close(result, torch.full((3,), 2.0))


def test_debug_nans_raises_on_the_first_nan():
    x = torch.tensor([1.0, -1.0])
    with pytest.raises(FloatingPointError, match="aten.log"):
        with debug_nans():
            torch.log(x)
    with debug_nans(enable=False):
        assert torch.isnan(torch.log(x)).any()
    assert torch.isnan(torch.log(x)).any()  # nothing checks outside the block
    with debug_nans():
        torch.exp(x).sum()  # no NaN: nothing raises


def test_debug_nans_sees_the_backward():
    """0 * inf in the backward of ``x * y`` at ``y = inf``'s gradient."""
    x = torch.tensor([0.0], requires_grad=True)
    y = torch.sqrt(x)  # finite forward, infinite derivative at 0
    with pytest.raises(FloatingPointError, match="NaN produced by"):
        with debug_nans():
            (y * 0.0).sum().backward()
