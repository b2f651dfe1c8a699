"""Batched Canny edge detection on the device (counterpart of saspa_tpu/ops/canny.py).

cv2.Canny(aperture=3, L2gradient=False) semantics as the JAX op has them:
3x3 Sobel per channel with edge replication, L1 magnitude, the channel with
the largest magnitude supplies (gx, gy) (first max wins), cv2's 4-sector
non-maximum suppression, double threshold, and hysteresis as an 8-connected
dilation fixpoint capped at H + W dilations.  On uint8 input every value is
an exact small integer in f32, so the result equals the JAX op bit for bit.

The fixpoint is tested for convergence every `check_every` dilations rather
than after each one (each test is a host sync): a dilation at the fixpoint
changes nothing, and the cap still bounds the total.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

TG22 = 0.4142135623730951  # tan(22.5 deg)


def canny_batch(imgs, low_threshold: float, high_threshold: float, max_hysteresis_iters: int = 0,
                check_every: int = 16):
    """imgs: (N, H, W, C) uint8 or float in [0, 255] -> (N, H, W) uint8 {0, 255}."""
    n, h, w = imgs.shape[:3]
    if max_hysteresis_iters == 0:
        max_hysteresis_iters = h + w
    x = imgs.float()
    if x.ndim == 3:
        x = x[..., None]
    p = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")  # (N, C, H+2, W+2)

    def s(dy, dx):  # neighbour at offset (dy, dx) of every pixel
        return p[:, :, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    gx = (s(-1, 1) - s(-1, -1)) + 2.0 * (s(0, 1) - s(0, -1)) + (s(1, 1) - s(1, -1))
    gy = (s(1, -1) - s(-1, -1)) + 2.0 * (s(1, 0) - s(-1, 0)) + (s(1, 1) - s(-1, 1))
    mag_c = gx.abs() + gy.abs()

    mag = mag_c.amax(dim=1)
    win_prev = mag_c[:, 0] >= mag
    gx_s, gy_s = gx[:, 0], gy[:, 0]
    for i in range(1, mag_c.shape[1]):
        win_i = (mag_c[:, i] >= mag) & ~win_prev
        gx_s = torch.where(win_i, gx[:, i], gx_s)
        gy_s = torch.where(win_i, gy[:, i], gy_s)
        win_prev = win_prev | win_i
    gx, gy = gx_s, gy_s

    tg22 = torch.tensor(TG22, dtype=torch.float32, device=x.device)
    ax, ay = gx.abs(), gy.abs()
    pm = F.pad(mag, (1, 1, 1, 1))

    def sh(dy, dx):
        return pm[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    horiz = ay < tg22 * ax
    vert = ay > torch.div(ax, tg22)
    diag_main = (gx * gy) >= 0
    n1 = torch.where(horiz, sh(0, -1), torch.where(vert, sh(-1, 0), torch.where(diag_main, sh(-1, -1), sh(-1, 1))))
    n2 = torch.where(horiz, sh(0, 1), torch.where(vert, sh(1, 0), torch.where(diag_main, sh(1, 1), sh(1, -1))))
    is_max = (mag > n1) & (mag >= n2)
    strong = is_max & (mag > high_threshold)
    weak = (is_max & (mag > low_threshold)).float()[:, None]

    cur = strong.float()[:, None]
    done = 0
    while done < max_hysteresis_iters:
        prev = cur
        for _ in range(min(check_every, max_hysteresis_iters - done)):
            cur = torch.maximum(torch.minimum(F.max_pool2d(cur, 3, stride=1, padding=1), weak), cur)
            done += 1
        if torch.equal(cur, prev):
            break
    return (cur[:, 0] > 0).to(torch.uint8) * 255


def canny(img, low_threshold: float, high_threshold: float, max_hysteresis_iters: int = 0):
    """One (H, W, C) or (H, W) image -> (H, W) uint8."""
    return canny_batch(img[None], low_threshold, high_threshold, max_hysteresis_iters)[0]


def canny_control_image(imgs, low: float, high: float):
    """(N, H, W, C) images -> (N, H, W, 3) f32 ControlNet conditioning in [0, 1]."""
    e = canny_batch(imgs, low, high).float() / 255.0
    return e[..., None].expand(*e.shape, 3).contiguous()
