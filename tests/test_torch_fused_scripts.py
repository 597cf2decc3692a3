"""The port's kernel entry points (``davo_tpu_torch.scripts``) on the CPU.

``check_fused_objective``, ``time_fused_objective`` and ``tune_bfgs_kernel``
run their plain versions at a small batch: only their control flow is
checked here (the lines they print and return; no time is read on the
CPU).  Their kernels are held against the plain versions in
``test_torch_gpu.py`` and by ``chip_smoke.py`` on the card.  The check's
differences (the polynomial atan2 of the kernels' function against the
exact atan2 of the plain objective, in float32) are held to 1e-4
normwise.
"""

import json

import pytest
import torch

from davo_tpu_torch.scripts import check_fused_objective, time_fused_objective, tune_bfgs_kernel
from tests.torch_port_helpers import torch_single_thread  # noqa: F401


def _printed(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def test_check_fused_objective(capsys):
    lines = check_fused_objective.main(device="cpu", batch=16)
    assert _printed(capsys) == lines
    k2, k4 = lines
    assert k2["kernel"].startswith("K2") and k4["kernel"].startswith("K4")
    assert k2["device"] == k4["device"] == "cpu"
    assert k2["max_abs_err_diff"] <= 1e-4 and k2["max_abs_grad_diff"] <= 1e-4 * max(1.0, k2["max_abs_grad"])
    assert k4["max_abs_err_diff"] <= 1e-4 and k4["max_abs_dphi_diff"] <= 1e-4 * max(1.0, k4["max_abs_dphi"])


def test_time_fused_objective(capsys):
    lines = time_fused_objective.main(device="cpu", batch=8)
    assert _printed(capsys) == lines
    assert [line["evaluation"] for line in lines] == [
        "torch value+grad", "K2 fused value+grad", "torch value+dirderiv", "K4 fused value+dirderiv",
    ]
    assert all(line["ms_per_eval"] == "not measured" for line in lines)


def test_chain_is_dependent():
    """Each evaluation starts where the last one stepped to."""
    seen = []

    def fn(q):
        seen.append(q.clone())
        return q.sum(dim=1), torch.ones_like(q)

    time_fused_objective.chain(fn, torch.zeros(2, 3), 3)
    assert [float(q[0, 0]) for q in seen] == pytest.approx([0.0, 1e-6, 2e-6])


def test_tune_bfgs_kernel(capsys):
    lines = tune_bfgs_kernel.main(device="cpu", batch=16)
    assert _printed(capsys) == lines
    cases = [(line["kernel"], line["block"], line["h_dtype"]) for line in lines]
    assert cases == [(name, block, str(dtype).replace("torch.", "")) for name, block, dtype in tune_bfgs_kernel.CASES]
    for line in lines:
        assert line["ms_per_20_iters"] == "not measured" and line["bound_ms_per_20_iters"] > 0
        assert line["elements_per_block"] == (32 if line["kernel"] == "broadcast" else line["block"] // 8)
        # on the CPU the wrapper runs the plain version itself
        assert line["check"]["max_abs_err"] == 0.0


def test_entry_points_need_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    for main in (check_fused_objective.main, time_fused_objective.main, tune_bfgs_kernel.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(batch=8)
