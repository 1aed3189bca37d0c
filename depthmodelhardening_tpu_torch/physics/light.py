"""Physical light simulation: closed-form light patterns of scalar
parameters (which may be tensors on the card).

Counterpart of `depthmodelhardening_tpu/physics/light.py:1-204`
(reference torchattacks/attacks/light_simulation.py, which builds the
patterns with per-pixel Python loops and scipy/cv2 on the host):

  * wavelength_to_rgb  - light_simulation.py:39-86, the piecewise visible
    spectrum with gamma 0.8, branchless;
  * tube_light_by_func - :124-163, full intensity within sqrt(beta) of
    the line y = k x + b, beta / d^2 out to sqrt(20 beta);
  * area_light         - :87-121, the rotations as flips and transposes;
  * tube_light_generation - :164-217, horizontal bands rotated about
    the centre (the JAX package's bilinear inverse rotation);
  * point_light_generation - the reference's stub (a zero pattern);
  * gaussian_add       - :30-38, pattern-modulated Gaussian noise;
  * simple_add         - :23-28, addWeighted in [0, 255] with the
    reference's uint8 round trip as a floor to 1/255 steps.

Every function computes in float32 as the JAX package's does, op for op.
"""

from __future__ import annotations

import torch

from ..ops.sampling import bilinear_sample_pixels

_F32 = torch.float32


def _f32(*vals):
    """The values as float32 tensors on the device of the first tensor
    among them (the CPU if none is). A number becomes a tensor filled on
    that device (`torch.full`), not a host-to-device copy, which would
    wait for the stream: the light search builds a light a candidate."""
    dev = next((v.device for v in vals if isinstance(v, torch.Tensor)),
               torch.device("cpu"))
    return [v.to(dtype=_F32) if isinstance(v, torch.Tensor)
            else torch.full((), float(v), dtype=_F32, device=dev)
            for v in vals]


def _safe_pow(base, exp: float):
    return torch.pow(torch.clamp(base, min=0.0), exp)


def wavelength_to_rgb(wavelength, gamma: float = 0.8):
    """Wavelength (nm) -> (R, G, B) in [0, 1], each a float32 tensor of
    the wavelength's shape."""
    (w,) = _f32(wavelength)

    def band(lo, hi):
        return (w >= lo) & (w <= hi)

    att1 = 0.3 + 0.7 * (w - 380.0) / 60.0
    att6 = 0.3 + 0.7 * (750.0 - w) / 105.0
    zero = torch.zeros_like(w)
    one = torch.ones_like(w)
    R = torch.where(band(380, 440), _safe_pow(-(w - 440) / 60.0 * att1, gamma),
        torch.where(band(440, 510), zero,
        torch.where(band(510, 580), _safe_pow((w - 510) / 70.0, gamma),
        torch.where(band(580, 645), one,
        torch.where(band(645, 750), _safe_pow(att6, gamma), zero)))))
    G = torch.where(band(440, 490), _safe_pow((w - 440) / 50.0, gamma),
        torch.where(band(490, 580), one,
        torch.where(band(580, 645), _safe_pow(-(w - 645) / 65.0, gamma),
                    zero)))
    G = torch.where(band(380, 440), zero, G)
    B = torch.where(band(380, 440), _safe_pow(att1, gamma),
        torch.where(band(440, 490), one,
        torch.where(band(490, 510), _safe_pow(-(w - 510) / 20.0, gamma),
                    zero)))
    return R, G, B


def _color(alpha, wavelength):
    R, G, B = wavelength_to_rgb(wavelength)
    return torch.stack([R, G, B]) * alpha


def tube_light_by_func(k, b, alpha, beta, wavelength, w: int, h: int):
    """Tube light along y = k x + b, (h, w, 3) float32, on the device of
    the parameters that are tensors. Keeps the reference's int(sqrt +
    0.5) truncations (light_simulation.py:124-163)."""
    k, b, alpha, beta, wavelength = _f32(k, b, alpha, beta, wavelength)
    dev = k.device
    xs = torch.arange(w, dtype=_F32, device=dev)[None, :]
    ys = torch.arange(h, dtype=_F32, device=dev)[:, None]
    dist = torch.abs(k * xs - ys + b) / torch.sqrt(1.0 + k * k)
    full_end = torch.trunc(torch.sqrt(beta) + 0.5)
    light_end = torch.trunc(torch.sqrt(beta * 20.0) + 0.5)
    atten = torch.where(
        dist <= full_end, 1.0,
        torch.where(dist <= light_end,
                    beta / torch.clamp(dist * dist, min=1e-12), 0.0))
    return atten[..., None] * _color(alpha, wavelength)[None, None, :]


def area_light(alpha, beta, wavelength, w: int = 150, h: int = 150,
               direction: str = "left"):
    """Area light (h, w, 3): full intensity out to sqrt(beta) columns
    (rows), beta / x^2 beyond (light_simulation.py:87-121); the
    reference's rotations are exact flips here."""
    alpha, beta, wavelength = _f32(alpha, beta, wavelength)
    full_end = torch.trunc(torch.sqrt(beta) + 0.5)

    def atten1d(n):
        t = torch.arange(n, dtype=_F32, device=beta.device)
        return torch.where(t < full_end, 1.0,
                           beta / torch.clamp(t * t, min=1e-12))

    color = _color(alpha, wavelength)
    if direction in ("left", "right"):
        a = atten1d(w)
        if direction == "right":
            a = a.flip(0)
        plane = a[None, :, None]
    elif direction in ("top", "bottom"):
        a = atten1d(h)
        if direction == "bottom":
            a = a.flip(0)
        plane = a[:, None, None]
    else:
        raise ValueError(direction)
    return (plane * color[None, None, :]).expand(h, w, 3)


def tube_light_generation(angle, alpha, beta, wavelength, w: int = 400,
                          h: int = 400):
    """Angle-form tube light (light_simulation.py:164-217), (h, w, 3):
    horizontal bands (full intensity in rows [light_end, total_dist),
    beta / d^2 flanks, row total_dist attenuated as the reference writes
    it; sqrt(10 beta) here, not the 20 of `tube_light_by_func`) rotated
    by `angle` degrees about the centre (`_rotate_image`)."""
    angle, alpha, beta, wavelength = _f32(angle, alpha, beta, wavelength)
    full_end = torch.trunc(torch.sqrt(beta) + 0.5)
    light_end = torch.trunc(torch.sqrt(beta * 10.0) + 0.5)
    total_dist = light_end + full_end
    r = torch.arange(h, dtype=_F32, device=beta.device)
    d_low = total_dist - r
    d_high = r - light_end
    att = torch.where(
        r <= light_end, beta / torch.clamp(d_low * d_low, min=1e-12),
        torch.where(r < total_dist, 1.0,
                    torch.where(r <= total_dist + light_end,
                                beta / torch.clamp(d_high * d_high,
                                                   min=1e-12), 0.0)))
    pattern = att[:, None, None] * _color(alpha, wavelength)[None, None, :]
    return _rotate_image(pattern.expand(h, w, 3), angle)


def _rotate_image(img, angle_deg):
    """ndimage.rotate(reshape=False, cval=0) as the JAX package does it:
    the output pixels' coordinates inverse-rotated about the centre,
    sampled bilinearly with zero fill, and zero wherever the source
    coordinate leaves the input. img (H, W, C)."""
    H, W = img.shape[:2]
    _, th = _f32(img, angle_deg)
    th = torch.deg2rad(th.to(img.device))
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    ys = torch.arange(H, dtype=_F32, device=img.device)[:, None] - cy
    xs = torch.arange(W, dtype=_F32, device=img.device)[None, :] - cx
    cos, sin = torch.cos(th), torch.sin(th)
    sy = (cos * ys + sin * xs + cy).expand(H, W)
    sx = (-sin * ys + cos * xs + cx).expand(H, W)
    out = bilinear_sample_pixels(img[None], sx[None], sy[None],
                                 padding_mode="zeros")[0]
    valid = (sy >= 0) & (sy <= H - 1) & (sx >= 0) & (sx <= W - 1)
    return out * valid[..., None].to(out.dtype)


def point_light_generation(st, alpha, beta, wavelength, w: int = 400,
                           h: int = 400):
    """The reference's unimplemented point light: a zero pattern
    (light_simulation.py:221-243)."""
    del st, alpha, beta, wavelength
    return torch.zeros((h, w, 3), dtype=_F32)


def gaussian_add(base_img, light_pattern, noise,
                 eps: float = 128 / 255.0):
    """Pattern-modulated Gaussian noise (light_simulation.py:30-38) in
    [0, 1]: noise (standard normal, base_img's shape; the JAX package
    draws it from its key) times eps * pattern, clipped to [-eps, eps],
    added without clamping the result, as the reference does."""
    g = torch.clamp(noise * eps * light_pattern, -eps, eps)
    return base_img + g


def simple_add(base_img, light_pattern, alpha: float = 1.0,
               quantize: bool = True):
    """Additive composite in [0, 1]; the reference works on uint8
    [0, 255] (phy_obj_atk_light.py:133-144), replicated as a floor to
    1/255 steps. base_img (..., H, W, 3), light_pattern (H, W, 3)."""
    out = torch.clamp(base_img + alpha * light_pattern, 0.0, 1.0)
    if quantize:
        out = torch.floor(out * 255.0) / 255.0
    return out


def light_k(angle):
    """The line slope of a light attack angle in degrees: tan(angle)
    rounded to 1/100, in float32 (JAX `light_object.py:_apply_light`)."""
    (angle,) = _f32(angle)
    return torch.round(torch.tan(torch.deg2rad(angle)) * 100.0) / 100.0

