"""Calibration objective value + gradient (kernel K2) and value +
directional derivative (kernel K4), with their plain versions.

The port of ``davo_tpu/ops/calibration_obj.py::calibration_value_and_grad``
(Pallas kernel ``_vg_kernel``) and ``::calibration_value_and_dirderiv``
(``_dirderiv_kernel``).  The TPU kernels take their derivatives from
``jax.vjp`` and ``jax.jvp`` at trace time; the CUDA kernels
(``csrc/calibration_obj.cu``, ``csrc/calibration_dirderiv.cu``) write the
reverse pass and the tangent pass of
:func:`davo_tpu_torch.camera.calibration_error_channel_major` with
``approx_atan2=True`` out by hand.  :func:`_value_and_grad_plain` and
:func:`_value_and_dirderiv_plain` perform the same hand-derived passes with
tensor operations, so the derivations are testable on the CPU against
``jax.vjp`` / ``jax.jvp`` and against ``torch.autograd`` / ``torch.func``.

:func:`calibration_value_and_grad` and :func:`calibration_value_and_dirderiv`
launch their kernels for CUDA tensors and run the plain versions for CPU
tensors; nothing else reaches the plain versions.
"""

from __future__ import annotations

import torch

from davo_tpu_torch.camera.calibration import num_calibration_parameters
from davo_tpu_torch.camera.calibration_fast import (
    ATAN_COEFFS,
    _PI_2,
    _PI_4,
    _TAN_PI_8,
    calibration_error_channel_major,
)
from davo_tpu_torch.geometry.distances import _NORM_FLOOR
from davo_tpu_torch.utils.stable_trig import (
    cos_sin_sq,
    one_minus_cos_sq,
    sin_cubed_sq,
    sinc_sq,
)

from . import build

__all__ = [
    "calibration_value_and_grad",
    "calibration_value_and_dirderiv",
    "make_fused_calibration_objective",
    "SUPPORTED_SCENES",
]

# (M, N) scene sizes compiled into the CUDA kernel
SUPPORTED_SCENES = ((4, 8),)


def _atan2_poly_and_partials(y, x):
    """``first_quadrant_atan2_poly(y, x)`` and its partials ``(d/dy, d/dx)``
    along the same where-branches."""
    c0, c1, c2, c3 = ATAN_COEFFS
    swap = y > x
    num = torch.where(swap, x, y)
    den_raw = torch.where(swap, y, x)
    den = torch.clamp(den_raw, min=1e-30)
    t = num / den
    reduced = t > _TAN_PI_8
    tr = torch.where(reduced, (t - 1.0) / (t + 1.0), t)
    z = tr * tr
    p = ((c0 * z + c1) * z + c2) * z + c3
    a = p * z * tr + tr + _PI_4 * reduced.to(t.dtype)
    dp = (3.0 * c0 * z + 2.0 * c1) * z + c2
    g_tr = (1.0 - 2.0 * swap.to(t.dtype)) * (1.0 + 3.0 * z * p + 2.0 * z * z * dp)
    g_t = torch.where(reduced, g_tr * 2.0 / ((t + 1.0) * (t + 1.0)), g_tr)
    g_num = g_t / den
    g_den = torch.where(den_raw > 1e-30, -g_t * t / den, 0.0)
    value = torch.where(swap, _PI_2 - a, a)
    return value, torch.where(swap, g_den, g_num), torch.where(swap, g_num, g_den)


def _guarded_sqrt_and_half_inverse(sq):
    """``sqrt(sq)`` (0 at 0) and ``1 / (2 sqrt(sq))`` (0 at 0)."""
    positive = sq > 0.0
    root = torch.sqrt(torch.where(positive, sq, 1.0))
    return torch.where(positive, root, 0.0), torch.where(positive, 0.5 / root, 0.0)


def _value_and_grad_plain(parameters, u_t, v_t, vis_t):
    """Value and gradient of the channel-major objective (polynomial
    atan2) by the hand-derived reverse pass of the CUDA kernel.

    :param parameters: ``(B, P)``.
    :param u_t, v_t, vis_t: ``(M, N, B)``.
    :return: ``(error (B,), gradient (B, P))``.
    """
    num_views, num_points = u_t.shape[0], u_t.shape[1]
    pt = parameters.T
    batch = pt.shape[-1]
    points_end = 3 + 3 * num_points
    trans_end = points_end + 3 * (num_views - 1)
    w = pt[3:points_end].reshape(num_points, 3, batch)  # raw points (N, 3, B)
    t = pt[points_end:trans_end].reshape(num_views - 1, 3, batch)
    r = pt[trans_end:].reshape(num_views - 1, 3, batch)
    f, cx, cy = pt[0], pt[1], pt[2]

    # ---- forward: gauge rescale and focal length
    abs_w = torch.sum(torch.abs(w), dim=(0, 1))
    abs_t = torch.sum(torch.abs(t), dim=(0, 1))
    overall = (
        abs_w / (3.0 * num_points) * num_points
        + abs_t / (3.0 * (num_views - 1)) * num_views
    ) / (num_points + num_views)
    inv_scale = 1.0 / torch.clamp(overall, min=1e-6)
    big_w = w * inv_scale  # (N, 3, B)
    positive = f > 0.0
    focal = torch.where(positive, f + 1.0, torch.exp(torch.where(positive, 0.0, f)))
    d_focal = torch.where(positive, 1.0, focal)

    g_w = torch.zeros_like(big_w)
    g_t = torch.zeros_like(t)
    g_r = torch.zeros_like(r)
    g_inv_scale = torch.zeros_like(f)
    g_focal = torch.zeros_like(f)
    g_cx = torch.zeros_like(f)
    g_cy = torch.zeros_like(f)
    total = torch.zeros_like(f)

    for m in range(num_views):
        # ---- forward: camera-relative points q (N, 3, B)
        if m == 0:
            q = big_w
        else:
            o = r[m - 1][None]  # (1, 3, B)
            big_t = t[m - 1][None] * inv_scale
            s_ang = torch.sum(o * o, dim=1)  # (1, B)
            f1 = sinc_sq(s_ang)
            f4 = one_minus_cos_sq(s_ang)
            cos_t = 1.0 - s_ang * f4
            dot = torch.sum(big_w * o, dim=1)  # (N, B)
            c = torch.linalg.cross(o.expand_as(big_w), big_w, dim=1)
            q = big_w * cos_t[:, None] + (f4 * dot)[:, None] * o + c * f1[:, None] + big_t
        qn = torch.sqrt(torch.sum(q * q, dim=1))  # (N, B)
        inv_qn = 1.0 / torch.clamp(qn, min=_NORM_FLOOR)
        # ---- forward: unit ray a and unit point direction bq
        ray = torch.stack([u_t[m] - cx, v_t[m] - cy, focal.expand_as(u_t[m])], dim=1)
        rn = torch.sqrt(torch.sum(ray * ray, dim=1))
        inv_rn = 1.0 / torch.clamp(rn, min=_NORM_FLOOR)
        a = ray * inv_rn[:, None]
        bq = q * inv_qn[:, None]
        dm = a - bq
        sm = a + bq
        diff, half_inv_diff = _guarded_sqrt_and_half_inverse(torch.sum(dm * dm, dim=1))
        summ, half_inv_summ = _guarded_sqrt_and_half_inverse(torch.sum(sm * sm, dim=1))
        angle, d_diff, d_summ = _atan2_poly_and_partials(diff, summ)
        weight = vis_t[m]
        total = total + torch.sum(2.0 * angle * weight, dim=0)

        # ---- reverse: angle -> |a - b|^2, |a + b|^2
        g_d2 = (2.0 * weight * d_diff * half_inv_diff)[:, None]
        g_s2 = (2.0 * weight * d_summ * half_inv_summ)[:, None]
        g_a = 2.0 * (g_d2 * dm + g_s2 * sm)
        g_b = 2.0 * (g_s2 * sm - g_d2 * dm)
        # ---- reverse: normalisations (norm gradient only above the floor)
        ga_a = torch.where(rn > _NORM_FLOOR, torch.sum(g_a * a, dim=1), 0.0)
        gb_b = torch.where(qn > _NORM_FLOOR, torch.sum(g_b * bq, dim=1), 0.0)
        g_q = inv_qn[:, None] * (g_b - bq * gb_b[:, None])
        g_ray = inv_rn[:, None] * (g_a - a * ga_a[:, None])
        g_cx = g_cx - torch.sum(g_ray[:, 0], dim=0)
        g_cy = g_cy - torch.sum(g_ray[:, 1], dim=0)
        g_focal = g_focal + torch.sum(g_ray[:, 2], dim=0)
        # ---- reverse: Rodrigues
        if m == 0:
            g_w = g_w + g_q
            continue
        gq_o = torch.sum(g_q * o, dim=1)  # (N, B)
        g_dot = f4 * gq_o
        g_cos = torch.sum(g_q * big_w, dim=(0, 1))
        g_f4 = torch.sum(gq_o * dot, dim=0)
        g_f1 = torch.sum(g_q * c, dim=(0, 1))
        g_c = f1[:, None] * g_q
        # c = o x W: dc.o -> W x g_c, dc.W -> g_c x o
        g_o = torch.sum(
            (f4 * dot)[:, None] * g_q
            + g_dot[:, None] * big_w
            + torch.linalg.cross(big_w, g_c, dim=1),
            dim=0,
        )
        g_w = (
            g_w
            + g_q * cos_t[:, None]
            + g_dot[:, None] * o
            + torch.linalg.cross(g_c, o.expand_as(g_c), dim=1)
        )
        g_big_t = torch.sum(g_q, dim=0)  # (3, B)
        # cos = 1 - s f4(s); f4' = sin_cubed_sq / 2; f1' = cos_sin_sq / 2
        s1 = s_ang[0]
        g_omc = g_f4 - s1 * g_cos
        g_s = (
            -f4[0] * g_cos
            + 0.5 * g_omc * sin_cubed_sq(s1)
            + 0.5 * g_f1 * cos_sin_sq(s1)
        )
        g_r[m - 1] = g_o + 2.0 * g_s * o[0]
        g_t[m - 1] = g_big_t * inv_scale
        g_inv_scale = g_inv_scale + torch.sum(g_big_t * t[m - 1], dim=0)

    # ---- reverse: gauge rescale
    g_inv_scale = g_inv_scale + torch.sum(g_w * w, dim=(0, 1))
    g_overall = torch.where(overall > 1e-6, -g_inv_scale * inv_scale * inv_scale, 0.0)
    g_abs_w = g_overall * num_points / (num_points + num_views) / (3.0 * num_points)
    g_abs_t = g_overall * num_views / (num_points + num_views) / (3.0 * (num_views - 1))
    g_points = g_w * inv_scale + g_abs_w * torch.sign(w)
    g_t = g_t + g_abs_t * torch.sign(t)

    grad_t = torch.cat(
        [
            torch.stack([g_focal * d_focal, g_cx, g_cy]),
            g_points.reshape(3 * num_points, batch),
            g_t.reshape(3 * (num_views - 1), batch),
            g_r.reshape(3 * (num_views - 1), batch),
        ]
    )
    return total, grad_t.T.contiguous()


def _max_tangent(x, floor, tangent):
    """The tangent of ``max(x, floor)`` (constant ``floor``) as ``jax.jvp``
    takes it: all of ``tangent`` above the floor, half at a tie, none below."""
    return torch.where(
        x > floor, tangent, torch.where(x == floor, 0.5 * tangent, torch.zeros_like(tangent))
    )


def _abs_tangent(x, tangent):
    """The tangent of ``|x|`` as ``jax.jvp`` takes it: ``+tangent`` for
    ``x >= 0`` (zero included), ``-tangent`` below."""
    return torch.where(x >= 0.0, tangent, -tangent)


def _cross(a, b):
    """``a x b`` for ``(3, ...)`` component stacks (broadcasting)."""
    return torch.stack(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ]
    )


def _value_and_dirderiv_plain(parameters, direction, u_t, v_t, vis_t):
    """Value and directional derivative of the channel-major objective
    (polynomial atan2) by the hand-derived tangent pass of the CUDA kernel:
    each intermediate carries its tangent along ``direction``; every
    ``where`` branch takes the local partials of :func:`_value_and_grad_plain`
    (:func:`_atan2_poly_and_partials`, :func:`_guarded_sqrt_and_half_inverse`,
    the squared-angle ratios' derivative family), contracted with the
    incoming tangent.  Clamps follow ``jax.jvp``: half the tangent at a tie
    of ``max``, ``+tangent`` for ``|x|`` at ``x = 0``.  A norm at or below
    its floor passes no tangent (where ``jax.jvp`` multiplies the 0 tangent
    of ``sqrt(0)`` by its infinite slope and gives NaN).

    :param parameters, direction: ``(B, P)``.
    :param u_t, v_t, vis_t: ``(M, N, B)``.
    :return: ``(error (B,), dphi (B,))``.
    """
    num_views, num_points = u_t.shape[0], u_t.shape[1]
    pt, dt = parameters.T, direction.T
    batch = pt.shape[-1]
    points_end = 3 + 3 * num_points
    trans_end = points_end + 3 * (num_views - 1)

    def split(x):
        return (
            x[3:points_end].reshape(num_points, 3, batch).transpose(0, 1),  # (3, N, B)
            x[points_end:trans_end].reshape(num_views - 1, 3, batch),
            x[trans_end:].reshape(num_views - 1, 3, batch),
        )

    w, t, r = split(pt)
    dw, d_t, dr = split(dt)
    f, cx, cy = pt[0], pt[1], pt[2]
    df, dcx, dcy = dt[0], dt[1], dt[2]

    # ---- gauge rescale, in the objective's order of operations
    points_scale = torch.mean(torch.abs(w[0]) + torch.abs(w[1]) + torch.abs(w[2]), dim=0) / 3.0
    d_points_scale = torch.mean(
        _abs_tangent(w[0], dw[0]) + _abs_tangent(w[1], dw[1]) + _abs_tangent(w[2], dw[2]), dim=0
    ) / 3.0
    camera_scale = torch.mean(torch.abs(t), dim=(0, 1))
    d_camera_scale = torch.mean(_abs_tangent(t, d_t), dim=(0, 1))
    overall = (points_scale * num_points + camera_scale * num_views) / (num_points + num_views)
    d_overall = (d_points_scale * num_points + d_camera_scale * num_views) / (num_points + num_views)
    inv_scale = 1.0 / torch.clamp(overall, min=1e-6)
    d_inv_scale = -inv_scale * inv_scale * _max_tangent(overall, 1e-6, d_overall)
    big_w = w * inv_scale  # (3, N, B)
    d_big_w = dw * inv_scale + w * d_inv_scale

    # ---- focal length elu(f) + 1 and the rays (u - cx, v - cy, f')
    positive = f > 0.0
    focal = torch.where(positive, f + 1.0, torch.exp(torch.where(positive, 0.0, f)))
    d_focal = torch.where(positive, df, focal * df)
    ray = torch.stack([u_t - cx, v_t - cy, focal.expand_as(u_t)])  # (3, M, N, B)
    d_ray = torch.stack([(-dcx).expand_as(u_t), (-dcy).expand_as(u_t), d_focal.expand_as(u_t)])
    rn = torch.sqrt(torch.sum(ray * ray, dim=0))
    inv_rn = 1.0 / torch.clamp(rn, min=_NORM_FLOOR)
    d_rn = torch.where(rn > 0.0, torch.sum(ray * d_ray, dim=0) / torch.where(rn > 0.0, rn, 1.0), 0.0)
    d_inv_rn = -inv_rn * inv_rn * _max_tangent(rn, _NORM_FLOOR, d_rn)
    a = ray * inv_rn
    d_a = d_ray * inv_rn + ray * d_inv_rn

    total = torch.zeros_like(f)
    d_total = torch.zeros_like(f)
    for m in range(num_views):
        # ---- camera-relative points q (3, N, B) and their tangents
        if m == 0:
            q, dq = big_w, d_big_w
        else:
            o, do = r[m - 1][:, None], dr[m - 1][:, None]  # (3, 1, B)
            big_t = t[m - 1][:, None] * inv_scale
            d_big_t = d_t[m - 1][:, None] * inv_scale + t[m - 1][:, None] * d_inv_scale
            s_ang = torch.sum(o * o, dim=0)  # (1, B)
            d_s = 2.0 * torch.sum(o * do, dim=0)
            f1 = sinc_sq(s_ang)
            f4 = one_minus_cos_sq(s_ang)
            d_f1 = 0.5 * cos_sin_sq(s_ang) * d_s
            d_f4 = 0.5 * sin_cubed_sq(s_ang) * d_s
            cos_t = 1.0 - s_ang * f4
            d_cos = -(d_s * f4 + s_ang * d_f4)
            dot = torch.sum(big_w * o, dim=0)  # (N, B)
            d_dot = torch.sum(d_big_w * o + big_w * do, dim=0)
            c = _cross(o, big_w)
            d_c = _cross(do, big_w) + _cross(o, d_big_w)
            q = big_w * cos_t + (f4 * dot) * o + c * f1 + big_t
            dq = (
                d_big_w * cos_t
                + big_w * d_cos
                + (d_f4 * dot + f4 * d_dot) * o
                + (f4 * dot) * do
                + d_c * f1
                + c * d_f1
                + d_big_t
            )
        qn = torch.sqrt(torch.sum(q * q, dim=0))  # (N, B)
        inv_qn = 1.0 / torch.clamp(qn, min=_NORM_FLOOR)
        d_qn = torch.where(qn > 0.0, torch.sum(q * dq, dim=0) / torch.where(qn > 0.0, qn, 1.0), 0.0)
        d_inv_qn = -inv_qn * inv_qn * _max_tangent(qn, _NORM_FLOOR, d_qn)
        bq = q * inv_qn
        d_bq = dq * inv_qn + q * d_inv_qn
        # ---- Kahan angle 2 atan2(|a - b|, |a + b|)
        dm, sm = a[:, m] - bq, a[:, m] + bq
        d_dm, d_sm = d_a[:, m] - d_bq, d_a[:, m] + d_bq
        diff, half_inv_diff = _guarded_sqrt_and_half_inverse(torch.sum(dm * dm, dim=0))
        summ, half_inv_summ = _guarded_sqrt_and_half_inverse(torch.sum(sm * sm, dim=0))
        d_diff = half_inv_diff * 2.0 * torch.sum(dm * d_dm, dim=0)
        d_summ = half_inv_summ * 2.0 * torch.sum(sm * d_sm, dim=0)
        angle, p_diff, p_summ = _atan2_poly_and_partials(diff, summ)
        weight = vis_t[m]
        total = total + torch.sum(2.0 * angle * weight, dim=0)
        d_total = d_total + torch.sum(2.0 * (p_diff * d_diff + p_summ * d_summ) * weight, dim=0)
    return total, d_total


def _check_kernel_inputs(tensors, u_t):
    """Raise unless the CUDA kernels take these ``(name, tensor)`` pairs:
    a compiled ``(M, N)``, ``(B, P)`` vectors and ``(M, N, B)``
    observations, all contiguous float32 on one card."""
    device = tensors[0][1].device
    num_views, num_points, batch = u_t.shape
    if (num_views, num_points) not in SUPPORTED_SCENES:
        raise ValueError(
            f"the CUDA kernel is compiled for (M, N) in {SUPPORTED_SCENES}, "
            f"got {(num_views, num_points)}"
        )
    p = num_calibration_parameters(num_views, num_points)
    for name, x in tensors:
        if x.dtype != torch.float32 or x.device != device or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {device}")
        expected = (batch, p) if x.dim() == 2 else tuple(u_t.shape)
        if tuple(x.shape) != expected:
            raise ValueError(f"expected {name} of shape {expected}, got {tuple(x.shape)}")
    return batch, p


def _device_kind(parameters):
    if parameters.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {parameters.device}")
    return parameters.device.type


def calibration_value_and_grad(
    parameters: torch.Tensor,
    u_t: torch.Tensor,
    v_t: torch.Tensor,
    vis_t: torch.Tensor,
):
    """Error and full gradient of the calibration objective (kernel K2).

    :param parameters: ``(B, P)`` flat calibration vectors.
    :param u_t, v_t: ``(M, N, B)`` observed pixel components (channel-major).
    :param vis_t: ``(M, N, B)`` visibility as floats.
    :return: ``(error (B,), gradient (B, P))``.
    """
    if _device_kind(parameters) == "cpu":
        return _value_and_grad_plain(parameters, u_t, v_t, vis_t)
    batch, p = _check_kernel_inputs(
        [("parameters", parameters), ("u_t", u_t), ("v_t", v_t), ("vis_t", vis_t)], u_t
    )
    lib = build.load_library()
    error = torch.empty(batch, device=parameters.device, dtype=torch.float32)
    gradient = torch.empty(batch, p, device=parameters.device, dtype=torch.float32)
    status = lib.davo_calibration_value_and_grad(
        parameters.data_ptr(),
        u_t.data_ptr(),
        v_t.data_ptr(),
        vis_t.data_ptr(),
        error.data_ptr(),
        gradient.data_ptr(),
        batch,
        u_t.shape[0],
        u_t.shape[1],
        torch.cuda.current_stream(parameters.device).cuda_stream,
    )
    build.check_launch(status, "calibration_value_and_grad")
    build.launch_counts["calibration_value_and_grad"] += 1
    return error, gradient


def calibration_value_and_dirderiv(
    parameters: torch.Tensor,
    direction: torch.Tensor,
    u_t: torch.Tensor,
    v_t: torch.Tensor,
    vis_t: torch.Tensor,
):
    """Error and directional derivative along ``direction`` of the
    calibration objective (kernel K4): one line-search probe in forward
    mode.

    :param parameters: ``(B, P)`` flat calibration vectors.
    :param direction: ``(B, P)`` tangent (the search direction).
    :param u_t, v_t: ``(M, N, B)`` observed pixel components (channel-major).
    :param vis_t: ``(M, N, B)`` visibility as floats.
    :return: ``(error (B,), dphi (B,))``.
    """
    if _device_kind(parameters) == "cpu":
        return _value_and_dirderiv_plain(parameters, direction, u_t, v_t, vis_t)
    batch, _ = _check_kernel_inputs(
        [("parameters", parameters), ("direction", direction), ("u_t", u_t), ("v_t", v_t),
         ("vis_t", vis_t)],
        u_t,
    )
    lib = build.load_library()
    error = torch.empty(batch, device=parameters.device, dtype=torch.float32)
    dphi = torch.empty(batch, device=parameters.device, dtype=torch.float32)
    status = lib.davo_calibration_value_and_dirderiv(
        parameters.data_ptr(),
        direction.data_ptr(),
        u_t.data_ptr(),
        v_t.data_ptr(),
        vis_t.data_ptr(),
        error.data_ptr(),
        dphi.data_ptr(),
        batch,
        u_t.shape[0],
        u_t.shape[1],
        torch.cuda.current_stream(parameters.device).cuda_stream,
    )
    build.check_launch(status, "calibration_value_and_dirderiv")
    build.launch_counts["calibration_value_and_dirderiv"] += 1
    return error, dphi


def make_fused_calibration_objective(
    projected_points: torch.Tensor, visibility_mask: torch.Tensor
):
    """The objective closures of one problem batch for the eval solve.

    The observations are transposed to channel-major once, outside the
    solver loop.  Returns ``(error_fn, value_and_grad_fn)``:

    * ``error_fn(params) -> (B,)`` — the plain channel-major objective,
      which the Wolfe search's forward-mode probes differentiate;
    * ``value_and_grad_fn(params) -> ((B,), (B, P))`` — kernel K2, for
      the ``value_and_grad_fn`` hook of
      :func:`davo_tpu_torch.solve.bfgs_solve`.

    Eval only: ``value_and_grad_fn`` is not differentiable.

    :param projected_points: ``(B, M, N, 2)`` observed pixels.
    :param visibility_mask: ``(B, M, N)`` boolean or float visibility.
    """
    dtype = torch.promote_types(projected_points.dtype, torch.float32)
    u_t = projected_points[..., 0].permute(1, 2, 0).to(dtype).contiguous()
    v_t = projected_points[..., 1].permute(1, 2, 0).to(dtype).contiguous()
    vis_t = visibility_mask.permute(1, 2, 0).to(dtype).contiguous()

    def error_fn(params):
        return calibration_error_channel_major(params.T, u_t, v_t, vis_t)

    def value_and_grad_fn(params):
        return calibration_value_and_grad(params.contiguous(), u_t, v_t, vis_t)

    return error_fn, value_and_grad_fn
