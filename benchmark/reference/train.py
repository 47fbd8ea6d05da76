"""Plain PyTorch reference of the material-training step: render the frame
with the albedo table being fitted, denoise it with the history of the
previous step, take ``mean((denoised − target)²)``, differentiate it with
respect to the table by autograd, take one Adam step (β = (0.9, 0.999),
ε = 1e-8, the textbook update with bias correction) and clamp the table to
[0, 1].  The history passes to the next step without a gradient.

It imports nothing of the program; the geometry does not depend on the
albedo, so nothing but the shading, the denoiser and the loss carries the
gradient.
"""

from __future__ import annotations

import torch

from . import denoise, render


class Adam:
    """The Adam update of one leaf, written out."""

    def __init__(self, lr, betas=(0.9, 0.999), eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.m = self.v = None
        self.t = 0

    def step(self, p, g):
        if self.m is None:
            self.m, self.v = torch.zeros_like(p), torch.zeros_like(p)
        self.t += 1
        self.m = self.b1 * self.m + (1 - self.b1) * g
        self.v = self.b2 * self.v + (1 - self.b2) * g * g
        m_hat = self.m / (1 - self.b1 ** self.t)
        v_hat = self.v / (1 - self.b2 ** self.t)
        return p - self.lr * m_hat / (torch.sqrt(v_hat) + self.eps)


def train(scene, cam, target, albedo0, generator, cfg, rm, params, lr,
          steps, *, hist=None, adam=None):
    """``steps`` training steps from the table ``albedo0`` and the history
    ``hist`` (default: empty), the light points drawn from ``generator``
    one frame a step; ``adam`` ``(m, v, t)`` is Adam's state after ``t``
    steps (default: none taken).  Returns per step ``(loss, gradient,
    table after the step)``, and the history after the first step."""
    H, W = cfg["height"], cfg["width"]
    if hist is None:
        hist = denoise.zero_history(H, W, dtype=target.dtype,
                                    device=target.device)
    opt = Adam(lr)
    if adam is not None:
        opt.m, opt.v, opt.t = adam
    table = albedo0.detach().clone()
    out, first_hist = [], None
    for _ in range(steps):
        leaf = table.clone().requires_grad_(True)
        g = render.render(scene, cam, None, generator, cfg, rm,
                          albedo_table=leaf)
        denoised, new_hist = denoise.denoise(g, hist, params)
        loss = torch.mean((denoised - target) ** 2)
        (grad,) = torch.autograd.grad(loss, leaf)
        with torch.no_grad():
            table = torch.clamp(opt.step(table, grad), 0.0, 1.0)
        hist = {k: v.detach() for k, v in new_hist.items()}
        first_hist = hist if first_hist is None else first_hist
        out.append((loss.detach(), grad.detach(), table.clone()))
        del g, denoised, new_hist, loss
    return out, first_hist
