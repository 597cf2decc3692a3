"""The port's mesh set-up and communication model against the JAX
package's, in this process (no process group is started: the collectives
run at 4 ranks in ``test_torch_parallel.py``).

``initialize_distributed``'s error contract mirrors
``tests/parallel/test_mesh_init.py`` with ``torch.distributed.
init_process_group`` mocked; the comm model's inventories and
predictions must equal the JAX module's exactly (plain arithmetic).
"""

import dataclasses

import pytest
import torch.distributed as dist

from davo_tpu.parallel import comm_model as jc
from davo_tpu_torch.parallel import comm_model as tc
from davo_tpu_torch.parallel import initialize_distributed, make_mesh

SIZES = [(4, 16, 8), (4, 64, 8), (32, 4096, 4), (8, 64, 2), (3, 12, 1)]


def test_explicit_misconfiguration_raises(monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(dist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="explicitly configured"):
        initialize_distributed(coordinator_address="10.0.0.1:1234", num_processes=4, process_id=0, device="cpu")


def test_autodetect_failure_warns_and_continues(monkeypatch):
    def boom(*args, **kwargs):
        raise ValueError("environment variable MASTER_ADDR expected, but not set")

    monkeypatch.setattr(dist, "init_process_group", boom)
    with pytest.warns(UserWarning, match="continuing single-process"):
        rank = initialize_distributed(device="cpu")
    assert rank == 0


def test_success_path_returns_the_rank(monkeypatch):
    calls = {}

    def fake(backend, **kwargs):
        calls.update(backend=backend, **kwargs)

    monkeypatch.setattr(dist, "init_process_group", fake)
    rank = initialize_distributed(coordinator_address="10.0.0.1:1234", num_processes=1, process_id=0, device="cpu")
    assert calls == dict(backend="gloo", init_method="tcp://10.0.0.1:1234", world_size=1, rank=0)
    assert rank == 0  # the mocked group was not created: a single process


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        make_mesh(device="cpu")


def _as_tuples(traffic):
    return [dataclasses.astuple(t) for t in traffic]


@pytest.mark.parametrize("m,n,devices", SIZES)
@pytest.mark.parametrize("dtype_bytes", [4, 8])
def test_schur_1d_traffic_matches_jax(m, n, devices, dtype_bytes):
    got = tc.schur_1d_traffic(m, n, devices, dtype_bytes=dtype_bytes)
    expected = jc.schur_1d_traffic(m, n, devices, dtype_bytes=dtype_bytes)
    assert _as_tuples(got) == _as_tuples(expected)
    assert tc.wire_bytes_per_device(got) == jc.wire_bytes_per_device(expected)


@pytest.mark.parametrize("m,n,a,b", [(4, 16, 2, 2), (8, 64, 4, 2), (8, 64, 2, 4), (32, 4096, 4, 2), (4, 16, 1, 4)])
def test_schur_2d_traffic_matches_jax(m, n, a, b):
    got = tc.schur_2d_traffic(m, n, a, b, dtype_bytes=8)
    expected = jc.schur_2d_traffic(m, n, a, b, dtype_bytes=8)
    assert _as_tuples(got) == _as_tuples(expected)
    assert tc.wire_bytes_per_device(got) == jc.wire_bytes_per_device(expected)


@pytest.mark.parametrize("link", [9.0e10, 2.5e9, 4.5e11])
def test_predict_efficiency_matches_jax(link):
    for traffic in (tc.schur_2d_traffic(32, 4096, 4, 2), tc.schur_1d_traffic(4, 64, 8)):
        j_traffic = [jc.Collective(*dataclasses.astuple(t)) for t in traffic]
        got = tc.predict_efficiency(5e-3, traffic, devices=8, serial_fraction=0.1, link_bytes_per_second=link)
        expected = jc.predict_efficiency(5e-3, j_traffic, devices=8, serial_fraction=0.1,
                                         link_bytes_per_second=link)
        assert got == expected


def test_predict_efficiency_takes_no_default_link_rate():
    """The JAX default was a TPU interconnect's rate; the port states none."""
    with pytest.raises(TypeError, match="link_bytes_per_second"):
        tc.predict_efficiency(5e-3, tc.schur_1d_traffic(4, 64, 8), devices=8)


def test_ring_wire_bytes():
    assert tc.Collective("x", group_size=8, payload_bytes=1000).wire_bytes() == pytest.approx(2 * 1000 * 7 / 8)
    assert tc.Collective("y", 1, 1000).wire_bytes() == 0.0
