"""Seeded picture content, made on the device in a few large calls.

`plates` is `tests/make_fixtures.make_yuv` rewritten in PyTorch: moving
textured plates over a smooth gradient, a global pan and sensor noise.  A
traffic file names the generator and its parameters.  The plates' sizes,
textures, colours, start positions and velocities come from the file's
`shape_seed`; the run's seed draws the sensor noise and the order in which
the plates are stacked.  So every seed codes the same plates along the same
paths, in another order, and the work barely depends on the seed.
"""

from __future__ import annotations

import numpy as np
import torch


def _fixed_set(p, w, h):
    """The plates every seed shares (make_yuv's draws and ranges)."""
    rng = np.random.default_rng(int(p["shape_seed"]))
    n = int(p["plates"])
    sx, sy = p["max_speed"]
    return dict(
        px=rng.uniform(0, w, n), py=rng.uniform(0, h, n),
        vx=rng.uniform(-sx, sx, n), vy=rng.uniform(-sy, sy, n),
        pw=rng.uniform(w / 8, w / 3, n), ph=rng.uniform(h / 8, h / 3, n),
        freq=rng.uniform(0.2, 1.4, (n, 2)), amp=rng.uniform(30, 90, n),
        cb=rng.uniform(-40, 40, n), cr=rng.uniform(-40, 40, n))


CHUNK = 16          # frames made per batch of device calls


def plates(p, w, h, n_frames, seed, device):
    """n_frames pictures [Y, Cb, Cr] as uint8 host arrays (4:2:0)."""
    fx = _fixed_set(p, w, h)
    n = int(p["plates"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    f32 = dict(dtype=torch.float32, device=device)

    order = torch.randperm(n, generator=g, device=device)
    px, py, vx, vy, pw, ph, freq, amp, cbo, cro = (
        torch.as_tensor(fx[k], **f32)[order]
        for k in ("px", "py", "vx", "vy", "pw", "ph", "freq", "amp", "cb",
                  "cr"))
    yy = torch.arange(h, **f32)[None, :, None]
    xx = torch.arange(w, **f32)[None, None, :]
    base = 60 + 60 * torch.sin(xx / w * 3.1) * torch.cos(yy / h * 2.3)
    pan_x, pan_y = p["pan"]
    sigma = float(p["noise_sigma"])
    out = []
    for f0 in range(0, n_frames, CHUNK):
        nb = min(CHUNK, n_frames - f0)
        f = torch.arange(f0, f0 + nb, **f32)[:, None, None]
        y = base + 10 * torch.sin((xx + pan_x * f) / 7.0) \
            * torch.sin((yy + pan_y * f) / 9.0)
        cb = torch.full((nb, h, w), 128.0, **f32)
        cr = torch.full((nb, h, w), 128.0, **f32)
        for i in range(n):
            cx = torch.remainder(px[i] + vx[i] * f, w + pw[i]) - pw[i] / 2
            cy = torch.remainder(py[i] + vy[i] * f, h + ph[i]) - ph[i] / 2
            m = ((xx - cx).abs() < pw[i] / 2) & ((yy - cy).abs() < ph[i] / 2)
            tex = amp[i] * torch.sin((xx - cx) * freq[i, 0]) \
                * torch.cos((yy - cy) * freq[i, 1])
            y = torch.where(m, 110 + tex, y)
            cb = torch.where(m, 128 + cbo[i], cb)
            cr = torch.where(m, 128 + cro[i], cr)
        y = y + sigma * torch.randn((nb, h, w), generator=g, **f32)
        planes = [y] + [c.reshape(nb, h // 2, 2, w // 2, 2).mean((2, 4))
                        for c in (cb, cr)]
        host = [q.clamp(0, 255).round().to(torch.uint8).cpu().numpy()
                for q in planes]
        out += [[q[i] for q in host] for i in range(nb)]
    return out


GENERATORS = {"plates": plates}


def make_frames(traffic, w, h, n_frames, seed, device):
    gen = GENERATORS[traffic["content"]["generator"]]
    return gen(traffic["content"], w, h, n_frames, seed, device)
