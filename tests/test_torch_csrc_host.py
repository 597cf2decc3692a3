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

Shuffles are emulated through a per-block exchange buffer between two
barrier arrivals (``tests/csrc_host/cuda_runtime.h``); so are K3's
warp-collective tensor-core product (``mma.sync`` m16n8k8 TF32) and its
``ldmatrix`` loads, in the card's fragment layouts, by the stand-in for
``csrc/mma_tf32.cuh`` (``tests/csrc_host/mma_tf32.cuh``, checked on its
own against numpy).  Asynchronous copies land only at the wait that
the card guarantees (``tests/csrc_host/cuda_pipeline.h``).

Tolerances, float32 on both sides: K1 and K1′ normwise 1e-4 (bfloat16 H:
1e-2, one rounding of the stored H), K2 values 1e-5 and gradients 1e-4
normwise, K4 values 1e-5 and directional derivatives 1e-4 normwise (at
(4, 8) and at the general kernels' sizes alike), K3
1e-5 normwise (QK^T as three TF32 products, "3xTF32", whose dropped term is
2^-22 of a product, and float32 sums in another order), with rows that
have no valid key exactly zero.
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


_DYNAMIC_SHARED = re.compile(r"extern __shared__ (?:__align__\(\d+\) )?float smem\[\];")


def _host_source(cu: str) -> str:
    cu = _DYNAMIC_SHARED.sub("float* smem = g_dyn_smem.data();", cu)
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


def _k1_problem(b, p, asymmetry=0.0):
    """Symmetric positive-definite H (plus ``asymmetry`` times a seeded
    normal matrix that is not symmetric), curvature pairs with y.s > 0
    but on the first 20 elements, a mixed updating mask."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(b, p, p)) / np.sqrt(p)
    h = np.eye(p) + a @ a.transpose(0, 2, 1)
    if asymmetry:
        h = h + asymmetry * np.random.default_rng(1).normal(size=(b, p, p))
    s = 0.1 * rng.normal(size=(b, p))
    c = rng.normal(size=(b, p, p)) / np.sqrt(p)
    y = np.einsum("bij,bj->bi", np.eye(p) + c @ c.transpose(0, 2, 1), s)  # y.s > 0
    y[:20] = -s[:20]  # y.s <= 0: update skipped
    g = rng.normal(size=(b, p))
    upd = rng.random(b) > 0.3
    s, y, g = (np.ascontiguousarray(x, dtype=np.float32) for x in (s, y, g))
    return h, s, y, g, upd


def _at_offset(x, offset):
    """``x`` copied into a buffer at ``offset`` elements from its start."""
    buf = np.empty(x.size + offset, x.dtype)
    out = buf[offset:].reshape(x.shape)
    out[...] = x
    return out


def _run_k1_source(launch, h, s, y, g, upd, bf16, plain, first, second, offset=0):
    """Launch a K1-shaped entry point on the host and hold H+ and d
    against ``plain`` (batch-major) on the same float32 inputs; H and H+
    lie ``offset`` elements into their buffers."""
    b, p = s.shape
    h_t = torch.tensor(h, dtype=torch.float32).permute(1, 2, 0).contiguous()
    if bf16:
        h_t = h_t.to(torch.bfloat16)
    h_in = _at_offset(h_t.view(torch.int16).numpy() if bf16 else h_t.numpy(), offset)
    h_out = _at_offset(np.empty_like(h_in), offset)
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
    b, p = 200, 45  # the last block ragged (16 elements a block; bfloat16 pairs, 32 a block)
    _run_k1_source(
        lambda *args: host_library.davo_bfgs_update_direction(*args, None),
        *_k1_problem(b, p), bf16, reference_update_direction, first, second,
    )


@pytest.mark.parametrize(
    "b,p",
    [
        (37, 7),  # register route, a small P, odd B (bfloat16 one element a thread): the last block ragged
        (40, 48),  # register route at its ceiling (kMaxRows = 48: 768 threads a block)
        (45, 49),  # above the ceiling: the two-pass route (32 elements a block)
        (70, 64),
        (75, 45),  # the served P at an odd B: bfloat16 one element a thread, 16 a block
    ],
)
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("first,second", [(True, False), (False, True), (False, False)])
def test_bfgs_update_source_around_the_register_ceiling(host_library, b, p, bf16, first, second):
    _run_k1_source(
        lambda *args: host_library.davo_bfgs_update_direction(*args, None),
        *_k1_problem(b, p), bf16, reference_update_direction, first, second,
    )


@pytest.mark.parametrize("first,second", [(True, False), (False, True), (False, False)])
def test_bfgs_update_source_bf16_carry_at_an_odd_element(host_library, first, second):
    """A bfloat16 carry that starts 2 bytes past a 4-byte boundary (a view
    at an odd element, B even): the packed pairs would be misaligned, which
    the stub reports as the card does, so K1 takes one element a thread."""
    _run_k1_source(
        lambda *args: host_library.davo_bfgs_update_direction(*args, None),
        *_k1_problem(64, 45), True, reference_update_direction, first, second, offset=1,
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


# K1' on a carry that is not symmetric, H + 0.05 N: the kernel reduces
# yᵀH over the rows, as the plain versions and the TPU kernels do.  A kernel
# that took yᵀH from Hy, as K1 does by symmetry, fails these tests on every
# step but the first (where no update applies): its d is off by about 5e-2
# normwise against the 1e-4 tolerance, its H+ by about 4e-2 against 1e-4
# (bfloat16 H: 1e-2) (test_nonsymmetric_carry_exposes_the_symmetric_shortcut).
NONSYMMETRIC = 0.05


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("elems", [16, 32, 64])
@pytest.mark.parametrize("scale_rows", [True, False])
@pytest.mark.parametrize("first,second", [(True, False), (False, True), (False, False)])
def test_bfgs_update_variant_source_on_a_nonsymmetric_carry(host_library, scale_rows, elems, bf16, first, second):
    """Every block size (float32 1, 2 or 4 tiles of 16; bfloat16 16 single
    elements, 32 and 64 one or two tiles of pairs), a ragged last block."""
    plain = reference_rowloop if scale_rows else reference_rowloop2
    _run_k1_source(
        lambda *args: host_library.davo_bfgs_update_variant(*args, int(scale_rows), elems, None),
        *_k1_problem(100, 45, NONSYMMETRIC), bf16, plain, first, second,
    )


@pytest.mark.parametrize("b,offset", [(75, 0), (64, 1)])  # an odd batch; a carry at an odd element
@pytest.mark.parametrize("elems", [32, 64])
@pytest.mark.parametrize("scale_rows", [True, False])
def test_bfgs_update_variant_source_unpaired_bf16_tiles(host_library, scale_rows, elems, b, offset):
    """bfloat16 H where no packed pair may be loaded: 2 or 4 tiles of 16
    single elements a block, on the nonsymmetric carry."""
    plain = reference_rowloop if scale_rows else reference_rowloop2
    for first, second in ((False, True), (False, False)):
        _run_k1_source(
            lambda *args: host_library.davo_bfgs_update_variant(*args, int(scale_rows), elems, None),
            *_k1_problem(b, 45, NONSYMMETRIC), True, plain, first, second, offset=offset,
        )


def _symmetric_shortcut(h, s, y, g, upd, first, second):
    """rowloop2 with yᵀH taken as (Hy)ᵀ: what a kernel on K1's shortcut
    would compute (batch-major)."""
    curvature = torch.sum(s * y, dim=-1)
    inv_c = torch.where(curvature > 0, 1.0 / torch.where(curvature > 0, curvature, 1.0), 0.0)
    scale = torch.clamp(curvature / torch.clamp(torch.sum(y * y, dim=-1), min=1e-5), min=1e-4)
    scale = scale if second else torch.ones_like(curvature)
    hy = torch.einsum("bij,bj->bi", h, y) * scale[:, None]
    coef = 1.0 + torch.sum(hy * y, dim=-1) * inv_c
    s_on_c = s * inv_c[:, None]
    applied = (upd & (not first)).float()[:, None, None]
    common = coef[:, None] * s - hy
    h_out = h * scale[:, None, None] + applied * (s_on_c[:, :, None] * common[:, None, :] - hy[:, :, None] * s_on_c[:, None, :])
    return h_out, (-g if first else -torch.einsum("bij,bj->bi", h_out, g))


def test_nonsymmetric_carry_exposes_the_symmetric_shortcut():
    """On the carry of the tests above, the shortcut misses the 1e-4
    tolerance on d on the later steps (by about 5e-2); on the symmetric
    carry it agrees."""
    for asymmetry, expect_miss in ((NONSYMMETRIC, True), (0.0, False)):
        h, s, y, g, upd = _k1_problem(100, 45, asymmetry)
        args = (torch.tensor(h, dtype=torch.float32), *(torch.tensor(x) for x in (s, y, g, upd)))
        for first, second in ((False, True), (False, False)):
            _, d = reference_rowloop2(*args, first, second)
            _, d_shortcut = _symmetric_shortcut(*args, first, second)
            miss = _normwise(d_shortcut.numpy(), d.numpy())
            assert (miss > 1e-3) if expect_miss else (miss <= 1e-5)


def test_bfgs_update_variant_refuses_unsupported(host_library):
    buf = np.zeros(64, np.float32)
    for p, elems in ((49, 16), (45, 8)):
        status = host_library.davo_bfgs_update_variant(
            *(buf.ctypes.data for _ in range(7)), 1, p, 0, 0, 0, 0, elems, None
        )
        assert status != 0


def _objective_problem(seed, b=300, m=4, n=8):
    """``b`` elements (300: 38 blocks of 8 for K2 and K4, the last one
    ragged) of ``m`` views and ``n`` points with the objective's edges:
    identity rotations, small angles (the Taylor branches), f < 0 and f = 0
    (the exp branch of elu(f) + 1), a view with nothing visible and an
    element that sees nothing."""
    rng = np.random.default_rng(seed)
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
    if b > 5:
        params[3, 0] = 0.0  # f = 0: the exp branch's edge
        vis[2, :, 4] = 0.0  # element 4: view 2 sees nothing
        vis[:, :, 5] = 0.0  # element 5 sees nothing
    direction = rng.normal(size=(b, p))
    return tuple(np.ascontiguousarray(x, dtype=np.float32) for x in (params, u, v, vis, direction))


def _run_k2_source(host_library, params, u, v, vis):
    (m, n, b), p = u.shape, params.shape[1]
    err = np.full(b + 1, np.nan, np.float32)  # one slot past the end: never written
    grad = np.full((b + 1, p), np.nan, np.float32)
    status = host_library.davo_calibration_value_and_grad(
        params.ctypes.data, u.ctypes.data, v.ctypes.data, vis.ctypes.data,
        err.ctypes.data, grad.ctypes.data, b, m, n, None,
    )
    assert status == 0
    assert np.isnan(err[b]) and np.all(np.isnan(grad[b]))
    ref_err, ref_grad = _value_and_grad_plain(*(torch.tensor(x) for x in (params, u, v, vis)))
    assert _normwise(err[:b], ref_err.numpy()) <= 1e-5
    assert _normwise(grad[:b], ref_grad.numpy()) <= 1e-4
    return err[:b], grad[:b]


@pytest.mark.parametrize("seed", [1, 2])
def test_calibration_value_and_grad_source(host_library, seed):
    err, grad = _run_k2_source(host_library, *_objective_problem(seed)[:4])
    assert err[5] == 0.0  # an element that sees nothing
    assert np.all(np.isfinite(grad))


@pytest.mark.parametrize("b", [3, 7, 13])
def test_calibration_value_and_grad_source_one_ragged_block(host_library, b):
    _run_k2_source(host_library, *_objective_problem(b, b)[:4])


def _run_k4_source(host_library, params, u, v, vis, direction):
    (m, n, b) = u.shape
    err = np.full(b + 1, np.nan, np.float32)  # one slot past the end: never written
    dphi = np.full(b + 1, np.nan, np.float32)
    status = host_library.davo_calibration_value_and_dirderiv(
        params.ctypes.data, direction.ctypes.data, u.ctypes.data, v.ctypes.data, vis.ctypes.data,
        err.ctypes.data, dphi.ctypes.data, b, m, n, None,
    )
    assert status == 0
    assert np.isnan(err[b]) and np.isnan(dphi[b])
    ref_err, ref_dphi = _value_and_dirderiv_plain(*(torch.tensor(x) for x in (params, direction, u, v, vis)))
    assert _normwise(err[:b], ref_err.numpy()) <= 1e-5
    assert _normwise(dphi[:b], ref_dphi.numpy()) <= 1e-4
    return err[:b], dphi[:b]


@pytest.mark.parametrize("seed", [1, 2])
def test_calibration_value_and_dirderiv_source(host_library, seed):
    err, dphi = _run_k4_source(host_library, *_objective_problem(seed))
    assert err[5] == 0.0 and dphi[5] == 0.0  # an element that sees nothing


@pytest.mark.parametrize("b", [3, 7, 13])
def test_calibration_value_and_dirderiv_source_one_ragged_block(host_library, b):
    _run_k4_source(host_library, *_objective_problem(b, b))


# sizes that take the general kernels (every size but (4, 8)): eval-seq's
# default (4, 32), fewer views (3, 8), N not a power of two (4, 12) and
# 96 terms in three chunks of 32 (6, 16); 21 elements, 3 blocks of 8 with
# the last one ragged
GENERAL_SCENES = [(4, 32), (3, 8), (4, 12), (6, 16)]


@pytest.mark.parametrize("m,n", GENERAL_SCENES)
def test_calibration_value_and_grad_source_general_sizes(host_library, m, n):
    err, grad = _run_k2_source(host_library, *_objective_problem(m * n, 21, m, n)[:4])
    assert err[5] == 0.0  # an element that sees nothing
    assert np.all(np.isfinite(grad))


@pytest.mark.parametrize("m,n", GENERAL_SCENES)
def test_calibration_value_and_dirderiv_source_general_sizes(host_library, m, n):
    err, dphi = _run_k4_source(host_library, *_objective_problem(m * n, 21, m, n))
    assert err[5] == 0.0 and dphi[5] == 0.0  # an element that sees nothing


@pytest.mark.parametrize("m,n", [(16, 17), (1, 8), (8, 0)])
def test_unsupported_scene_size_is_refused(host_library, m, n):
    """Above the cap of 256 terms (16 x 17 = 272), or a scene of one view
    or no point: refused before any launch."""
    buf = np.zeros(64, np.float32)
    status = host_library.davo_calibration_value_and_grad(
        *(buf.ctypes.data for _ in range(6)), 1, m, n, None
    )
    assert status != 0
    status = host_library.davo_calibration_value_and_dirderiv(
        *(buf.ctypes.data for _ in range(7)), 1, m, n, None
    )
    assert status != 0


@pytest.mark.parametrize(
    "b,q_len,kv_len,d,c,masked",
    [
        (2, 70, 90, 64, 2, True),  # ragged query tile, ragged key tile
        (1, 20, 144, 40, 3, False),  # D padded to 64 in shared memory, C to 8
        (2, 9, 33, 16, 2, True),  # D padded to 32
        (1, 5, 17, 100, 8, True),  # D padded to 128
        (2, 144, 144, 64, 2, False),  # the matcher's shape: no padded fragment, three key tiles
        (2, 144, 144, 64, 2, True),
        (2, 50, 211, 64, 2, True),  # five key tiles: the online rescaling across tiles
        (1, 37, 211, 100, 8, True),  # chip_smoke's masked_wide case: D = 100, C = 8
        (1, 30, 61, 100, 2, False),  # D = 100 unmasked, K = 61: a ragged second key tile
        (1, 16, 50, 37, 8, True),  # D = 37: rows staged by 4-byte copies, C = 8
        # sequential tracking: N = 8 track queries against a frame's 144
        # cells, one block's 144 query rows of which 8 are real
        (1, 8, 144, 64, 2, False),
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


_MMA_PROBE = r"""
#include <cuda_runtime.h>
#include "mma_tf32.cuh"
// One warp: C = A B (16 x 8 by 8 x 16, two m16n8k8 products) with A and B
// as given (mode 0: the tensor core reads their top 19 bits), rounded to
// TF32 (mode 1), or split into TF32 parts, A_s B_b + A_b B_s + A_b B_b
// (mode 2, "3xTF32").  The fragments come from shared memory by ldmatrix:
// A row-major, B as its transpose (16 rows of 8).
__global__ void probe(const float* a, const float* b, float* c, int mode) {
  __shared__ __align__(16) float a_sh[16 * 8], bt_sh[16 * 8];
  const int lane = threadIdx.x;
  for (int i = lane; i < 128; i += 32) {
    a_sh[i] = a[i];
    bt_sh[(i % 16) * 8 + i / 16] = b[i];  // b is 8 x 16 row-major
  }
  __syncwarp();
  uint32_t a_raw[4], b_raw[4], a_big[4], a_small[4], b_big[4], b_small[4];
  ldmatrix_x4(a_raw, a_sh + (lane & 15) * 8 + 4 * (lane >> 4));
  ldmatrix_x4(b_raw, bt_sh + (lane & 15) * 8 + 4 * (lane >> 4));
  for (int i = 0; i < 4; ++i) {
    const float x = __uint_as_float(a_raw[i]), y = __uint_as_float(b_raw[i]);
    a_big[i] = __float_as_uint(tf32_round(x));
    a_small[i] = __float_as_uint(tf32_round(x - __uint_as_float(a_big[i])));
    b_big[i] = __float_as_uint(tf32_round(y));
    b_small[i] = __float_as_uint(tf32_round(y - __uint_as_float(b_big[i])));
  }
  for (int h = 0; h < 2; ++h) {  // columns 8 h .. 8 h + 7
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    if (mode == 0) {
      mma_tf32_16x8x8(d, a_raw, b_raw[h], b_raw[h + 2]);
    } else {
      if (mode == 2) {
        mma_tf32_16x8x8(d, a_small, b_big[h], b_big[h + 2]);
        mma_tf32_16x8x8(d, a_big, b_small[h], b_small[h + 2]);
      }
      mma_tf32_16x8x8(d, a_big, b_big[h], b_big[h + 2]);
    }
    const int g = lane >> 2, t = lane & 3;
    for (int i = 0; i < 4; ++i) c[(g + 8 * (i >> 1)) * 16 + 8 * h + 2 * t + (i & 1)] = d[i];
  }
}
extern "C" int run_probe(const float* a, const float* b, float* c, int mode) {
  probe<<<1, 32, 0, nullptr>>>(a, b, c, mode);
  return static_cast<int>(cudaGetLastError());
}
extern "C" float round_tf32(float x) { return tf32_round(x); }
"""


def _tf32(x):
    """float32 rounded to nearest, ties away from zero, to 10 mantissa bits
    (cvt.rna.tf32.f32)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.fixture(scope="module")
def mma_probe(tmp_path_factory):
    compiler = shutil.which("g++") or shutil.which("c++")
    if compiler is None:
        pytest.skip("needs a C++20 host compiler (g++)")
    work = tmp_path_factory.mktemp("mma_probe")
    (work / "probe.cpp").write_text(_host_source(_MMA_PROBE))
    library = work / "libprobe.so"
    subprocess.run(
        [compiler, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", f"-I{STUBS}",
         "-Wno-unknown-pragmas", str(work / "probe.cpp"), "-o", str(library)],
        check=True, capture_output=True, text=True, timeout=300,
    )
    lib = ctypes.CDLL(str(library))
    lib.run_probe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.round_tf32.argtypes = [ctypes.c_float]
    lib.round_tf32.restype = ctypes.c_float
    return lib


@pytest.mark.parametrize("mode", ["tensor_core_reads_19_bits", "tf32", "3xtf32"])
def test_mma_stub_tf32_product(mma_probe, mode):
    """The host stand-in of the TF32 tensor-core product and its ldmatrix
    loads (tests/csrc_host/mma_tf32.cuh), one 16 x 16 x 8 product against
    numpy.  Unit-normal operands: a TF32 product is off by ~1e-3 of |C|,
    the split product by ~1e-7."""
    rng = np.random.default_rng(8)
    a = rng.normal(size=(16, 8)).astype(np.float32)
    b = rng.normal(size=(8, 16)).astype(np.float32)
    c = np.full((16, 16), np.nan, np.float32)
    code = ["tensor_core_reads_19_bits", "tf32", "3xtf32"].index(mode)
    assert mma_probe.run_probe(a.ctypes.data, b.ctypes.data, c.ctypes.data, code) == 0
    exact = a.astype(np.float64) @ b.astype(np.float64)
    if mode == "3xtf32":
        assert _normwise(c, exact) <= 1e-6
        return
    if mode == "tf32":
        a_in, b_in = _tf32(a), _tf32(b)
    else:  # the low 13 bits dropped
        a_in = (a.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
        b_in = (b.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
    # the rounded operands' product, summed in float32: to rounding
    assert _normwise(c, a_in.astype(np.float64) @ b_in.astype(np.float64)) <= 1e-6
    # ... and TF32 is not float32
    assert _normwise(c, exact) >= 1e-4


def test_tf32_rounding_ties_away_from_zero(mma_probe):
    """The rounding the K3 host build uses (and numpy's, the probe's
    reference): to nearest, a tie away from zero, unlike float32's ties to
    even (1 + ulp / 2 would round to 1)."""
    ulp = 2.0**-10  # TF32's at 1.0
    x = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0**-23, 1 + 1.5 * ulp], np.float32)
    expected = np.array([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp], np.float32)
    np.testing.assert_array_equal(_tf32(x), expected)
    np.testing.assert_array_equal(np.array([mma_probe.round_tf32(float(v)) for v in x], np.float32), expected)


def test_match_attention_refuses_unsupported_widths(host_library):
    buf = np.zeros(64, np.float32)
    for d, c in ((129, 2), (64, 9), (0, 2)):
        status = host_library.davo_match_attention(
            buf.ctypes.data, buf.ctypes.data, buf.ctypes.data, None, buf.ctypes.data,
            1, 2, 2, d, c, None,
        )
        assert status != 0
