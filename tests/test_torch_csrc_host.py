"""The CUDA sources of kernels K1, K1′, K2, K3 and K4, compiled for the host
and held against their plain PyTorch versions.

``nvcc`` and a card exist only on the GPU machine, so here each
``csrc/*.cu`` file is compiled by a C++20 host compiler against the stub
headers in ``tests/csrc_host/``: a launch runs every block in turn, the
block's threads as ``std::thread``s meeting at a barrier for
``__syncthreads``, shared memory as a host buffer.  This checks the
kernels' indexing, shared-memory staging, ragged last block and
arithmetic; what only the card can show (the device compiler, timing) is
``chip_smoke.py``'s.  The launch statement is rewritten from
``kernel<<<grid, block, shared, stream>>>(args)`` to a call of the stub's
``emulate``.

Tolerances, float32 on both sides: K1 and K1′ normwise 1e-4 (bfloat16 H:
1e-2, one rounding of the stored H), K2 values 1e-5 and gradients 1e-4
normwise, K4 values 1e-5 and directional derivatives 1e-4 normwise, K3
1e-5 normwise (float32 sums of D products and of the softmax weights in
another order), with rows that have no valid key exactly zero.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from davo_tpu_torch.ops.attention import reference_flash_attention
from davo_tpu_torch.ops.bfgs_update import reference_update_direction
from davo_tpu_torch.ops.bfgs_update_variants import reference_rowloop, reference_rowloop2
from davo_tpu_torch.ops.build import CSRC, SOURCES
from davo_tpu_torch.ops.calibration_obj import _value_and_dirderiv_plain, _value_and_grad_plain
from tests.torch_port_helpers import torch_single_thread  # noqa: F401

STUBS = Path(__file__).resolve().parent / "csrc_host"
_LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);", re.S)


def _host_source(cu: str) -> str:
    cu = cu.replace("extern __shared__ float smem[];", "float* smem = g_dyn_smem.data();")
    cu = cu.replace("__shared__ float tile", "static float tile")
    return _LAUNCH.sub(lambda m: f"emulate({m.group(2)}, [&]{{ {m.group(1)}({m.group(3)}); }});", cu)


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    compiler = shutil.which("g++") or shutil.which("c++")
    if compiler is None:
        pytest.skip("needs a C++20 host compiler (g++)")
    work = tmp_path_factory.mktemp("csrc_host")
    sources = []
    for name in SOURCES:
        path = work / (Path(name).stem + ".cpp")
        path.write_text(_host_source((CSRC / name).read_text()))
        sources.append(str(path))
    library = work / "libhost_kernels.so"
    subprocess.run(
        [compiler, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", f"-I{STUBS}", f"-I{CSRC}",
         "-Wno-unknown-pragmas", *sources, "-o", str(library)],
        check=True, capture_output=True, text=True, timeout=300,
    )
    lib = ctypes.CDLL(str(library))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.davo_bfgs_update_direction.argtypes = [p] * 7 + [i] * 5 + [p]
    lib.davo_bfgs_update_variant.argtypes = [p] * 7 + [i] * 7 + [p]
    lib.davo_calibration_value_and_grad.argtypes = [p] * 6 + [i] * 3 + [p]
    lib.davo_calibration_value_and_dirderiv.argtypes = [p] * 7 + [i] * 3 + [p]
    lib.davo_match_attention.argtypes = [p] * 5 + [i] * 5 + [p]
    return lib


def _normwise(actual, expected):
    return float(np.max(np.abs(actual - expected)) / max(1.0, float(np.max(np.abs(expected)))))


def _k1_problem(b, p):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(b, p, p)) / np.sqrt(p)
    h = np.eye(p) + a @ a.transpose(0, 2, 1)
    s = 0.1 * rng.normal(size=(b, p))
    c = rng.normal(size=(b, p, p)) / np.sqrt(p)
    y = np.einsum("bij,bj->bi", np.eye(p) + c @ c.transpose(0, 2, 1), s)  # y.s > 0
    y[:20] = -s[:20]  # y.s <= 0: update skipped
    g = rng.normal(size=(b, p))
    upd = rng.random(b) > 0.3
    s, y, g = (np.ascontiguousarray(x, dtype=np.float32) for x in (s, y, g))
    return h, s, y, g, upd


def _run_k1_source(launch, h, s, y, g, upd, bf16, plain, first, second):
    """Launch a K1-shaped entry point on the host and hold H+ and d
    against ``plain`` (batch-major) on the same float32 inputs."""
    b, p = s.shape
    h_t = torch.tensor(h, dtype=torch.float32).permute(1, 2, 0).contiguous()
    if bf16:
        h_t = h_t.to(torch.bfloat16)
    h_in = h_t.view(torch.int16).numpy() if bf16 else h_t.numpy()
    h_out = np.empty_like(h_in)
    d = np.empty((b, p), np.float32)
    mask = upd.astype(np.uint8)
    status = launch(
        h_in.ctypes.data, h_out.ctypes.data, s.ctypes.data, y.ctypes.data, g.ctypes.data,
        mask.ctypes.data, d.ctypes.data, b, p, int(first), int(second), int(bf16),
    )
    assert status == 0
    ref_h, ref_d = plain(
        h_t.permute(2, 0, 1).float(), torch.tensor(s), torch.tensor(y), torch.tensor(g),
        torch.tensor(upd), first, second,
    )
    ref_h = ref_h.to(h_t.dtype).float().numpy()
    got_h = (torch.tensor(h_out).view(torch.bfloat16).float().numpy() if bf16 else h_out).transpose(2, 0, 1)
    assert _normwise(got_h, ref_h) <= (1e-2 if bf16 else 1e-4)
    assert _normwise(d, ref_d.numpy()) <= 1e-4


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("first,second", [(True, False), (False, True), (False, False)])
def test_bfgs_update_source(host_library, bf16, first, second):
    b, p = 200, 45  # 7 blocks of 32 elements, the last one ragged
    _run_k1_source(
        lambda *args: host_library.davo_bfgs_update_direction(*args, None),
        *_k1_problem(b, p), bf16, reference_update_direction, first, second,
    )


@pytest.mark.parametrize(
    "scale_rows,elems,bf16",
    [(True, 16, False), (False, 16, False), (False, 32, True), (True, 64, True), (False, 64, False)],
)
@pytest.mark.parametrize("first,second", [(True, False), (False, True), (False, False)])
def test_bfgs_update_variant_source(host_library, scale_rows, elems, bf16, first, second):
    b, p = 100, 45  # a ragged last block at every block size
    plain = reference_rowloop if scale_rows else reference_rowloop2
    _run_k1_source(
        lambda *args: host_library.davo_bfgs_update_variant(*args, int(scale_rows), elems, None),
        *_k1_problem(b, p), bf16, plain, first, second,
    )


def test_bfgs_update_variant_refuses_unsupported(host_library):
    buf = np.zeros(64, np.float32)
    for p, elems in ((49, 16), (45, 8)):
        status = host_library.davo_bfgs_update_variant(
            *(buf.ctypes.data for _ in range(7)), 1, p, 0, 0, 0, 0, elems, None
        )
        assert status != 0


def _objective_problem(seed):
    rng = np.random.default_rng(seed)
    m, n = 4, 8
    b = 300  # 3 blocks of 128, the last one ragged
    p = 3 + 3 * n + 6 * (m - 1)
    params = 0.3 * rng.normal(size=(b, p))
    params[:, 0] += rng.normal(size=b)
    params[:, 5 : 3 + 3 * n : 3] += 1.0
    r0 = 3 + 3 * n + 3 * (m - 1)
    params[0, r0:] = 0.0  # identity rotations
    params[1, r0:] *= 1e-3  # the Taylor branches
    params[2, 0] = -0.5  # the exp branch of elu(f) + 1
    u = rng.uniform(-1, 1, size=(m, n, b))
    v = rng.uniform(-1, 1, size=(m, n, b))
    vis = (rng.random((m, n, b)) > 0.2).astype(np.float64)
    direction = rng.normal(size=(b, p))
    return tuple(np.ascontiguousarray(x, dtype=np.float32) for x in (params, u, v, vis, direction))


@pytest.mark.parametrize("seed", [1, 2])
def test_calibration_value_and_grad_source(host_library, seed):
    params, u, v, vis, _ = _objective_problem(seed)
    (m, n, b), p = u.shape, params.shape[1]
    err = np.empty(b, np.float32)
    grad = np.empty((b, p), np.float32)
    status = host_library.davo_calibration_value_and_grad(
        params.ctypes.data, u.ctypes.data, v.ctypes.data, vis.ctypes.data,
        err.ctypes.data, grad.ctypes.data, b, m, n, None,
    )
    assert status == 0
    ref_err, ref_grad = _value_and_grad_plain(*(torch.tensor(x) for x in (params, u, v, vis)))
    assert _normwise(err, ref_err.numpy()) <= 1e-5
    assert _normwise(grad, ref_grad.numpy()) <= 1e-4


@pytest.mark.parametrize("seed", [1, 2])
def test_calibration_value_and_dirderiv_source(host_library, seed):
    params, u, v, vis, direction = _objective_problem(seed)
    (m, n, b) = u.shape
    err = np.empty(b, np.float32)
    dphi = np.empty(b, np.float32)
    status = host_library.davo_calibration_value_and_dirderiv(
        params.ctypes.data, direction.ctypes.data, u.ctypes.data, v.ctypes.data, vis.ctypes.data,
        err.ctypes.data, dphi.ctypes.data, b, m, n, None,
    )
    assert status == 0
    ref_err, ref_dphi = _value_and_dirderiv_plain(*(torch.tensor(x) for x in (params, direction, u, v, vis)))
    assert _normwise(err, ref_err.numpy()) <= 1e-5
    assert _normwise(dphi, ref_dphi.numpy()) <= 1e-4


def test_unsupported_scene_size_is_refused(host_library):
    buf = np.zeros(64, np.float32)
    status = host_library.davo_calibration_value_and_grad(
        *(buf.ctypes.data for _ in range(6)), 1, 3, 5, None
    )
    assert status != 0
    status = host_library.davo_calibration_value_and_dirderiv(
        *(buf.ctypes.data for _ in range(7)), 1, 3, 5, None
    )
    assert status != 0


@pytest.mark.parametrize(
    "b,q_len,kv_len,d,c,masked",
    [
        (2, 70, 90, 64, 2, True),  # ragged query tile, ragged key tile and chunk
        (1, 20, 144, 40, 3, False),  # D padded to 64 in registers, C to 8
        (2, 9, 33, 16, 2, True),  # D padded to 32
        (1, 5, 17, 100, 8, True),  # D padded to 128
    ],
)
def test_match_attention_source(host_library, b, q_len, kv_len, d, c, masked):
    rng = np.random.default_rng(q_len * kv_len + d)
    q = rng.normal(size=(b, q_len, d)).astype(np.float32)
    k = rng.normal(size=(b, kv_len, d)).astype(np.float32)
    v = rng.normal(size=(b, kv_len, c)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.random((b, kv_len)) > 0.3
        mask[0, :] = False  # problem 0: every row without a valid key
    out = np.full((b, q_len, c), np.nan, np.float32)
    mask_u8 = None if mask is None else np.ascontiguousarray(mask.astype(np.uint8))
    status = host_library.davo_match_attention(
        q.ctypes.data, k.ctypes.data, v.ctypes.data,
        None if mask_u8 is None else mask_u8.ctypes.data, out.ctypes.data,
        b, q_len, kv_len, d, c, None,
    )
    assert status == 0
    ref = reference_flash_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), None if mask is None else torch.tensor(mask)
    ).numpy()
    assert _normwise(out, ref) <= 1e-5
    if masked:
        assert np.all(out[0] == 0.0)


def test_match_attention_refuses_unsupported_widths(host_library):
    buf = np.zeros(64, np.float32)
    for d, c in ((129, 2), (64, 9), (0, 2)):
        status = host_library.davo_match_attention(
            buf.ctypes.data, buf.ctypes.data, buf.ctypes.data, None, buf.ctypes.data,
            1, 2, 2, d, c, None,
        )
        assert status != 0
