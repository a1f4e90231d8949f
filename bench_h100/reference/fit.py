"""The reference of a fit: the loss, its gradient and Adam's update.

The loss is the mean over the film of (mean XYZ over the step's samples -
target) ** 2, by pixels in blocks: each block's part of the loss depends
on its own pixels alone, so its backward runs before the next block is
traced and only one block's graph lives at a time. Adam is written out
(the update of Kingma and Ba, with torch.optim.Adam's defaults), and
spectra are clamped at 0 after each update, as the program's training
step does.
"""

from __future__ import annotations

import torch

from bench_h100.reference import tracer

BETAS = (0.9, 0.999)
EPS = 1e-8


def loss_and_grads(scene, leaves: dict, target, width, height, spp,
                   first_sample, max_depth, rr_start, block_pixels,
                   rows=None):
    """(loss, {name: gradient}) at the leaves (spectra, data1), over the
    film's first ``rows`` rows (all by default)."""
    live = {k: v.detach().clone().requires_grad_(True)
            for k, v in leaves.items()}
    s = scene.with_leaves(**live)
    rows = height if rows is None else rows
    px, py = tracer.film_pixels(width, rows, target.device)
    tgt = target[:rows].reshape(-1, 3).to(scene.dtype)
    n_pix = width * rows
    n = float(n_pix * 3)
    loss = 0.0
    for b0 in range(0, n_pix, block_pixels):
        b1 = min(n_pix, b0 + block_pixels)
        acc = tracer.accumulate(s, width, height, px[b0:b1], py[b0:b1],
                                first_sample, spp, max_depth, rr_start)
        part = (((acc / float(spp)) - tgt[b0:b1]) ** 2).sum() / n
        part.backward()
        loss += float(part.detach().double())
    return loss, {k: v.grad.detach() for k, v in live.items()}


def follow(scene, leaves: dict, target, steps, lr, width, height, spp,
           first_sample, max_depth, rr_start, block_pixels, rows=None):
    """Adam from the leaves over ``steps`` steps on the same samples ->
    (losses, the first gradient, the leaves after the last step)."""
    p = {k: v.detach().clone() for k, v in leaves.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    b1, b2 = BETAS
    for t in range(1, steps + 1):
        loss, g = loss_and_grads(scene, p, target, width, height, spp,
                                 first_sample, max_depth, rr_start,
                                 block_pixels, rows)
        losses.append(loss)
        if first is None:
            first = g
        for k in p:
            m[k] = b1 * m[k] + (1.0 - b1) * g[k]
            v2[k] = b2 * v2[k] + (1.0 - b2) * g[k] * g[k]
            m_hat = m[k] / (1.0 - b1 ** t)
            v_hat = v2[k] / (1.0 - b2 ** t)
            p[k] = p[k] - lr * m_hat / (torch.sqrt(v_hat) + EPS)
        if "spectra" in p:
            p["spectra"] = p["spectra"].clamp(min=0.0)
    return losses, first, p
