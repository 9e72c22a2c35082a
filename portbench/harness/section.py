"""A tissue section made from the seed, on the device, in a few large calls.

The configuration gives the cells, the panel width, the extent of the
section and the count model: uniform coordinates over the extent; per gene
a base rate drawn log-normally; one gene in ``signal_every`` carries a
smooth spatial field (a plane wave of random direction, wavelength and
phase, ``signal_amp`` in log space); counts are Poisson and the matrix
holds log1p(counts), float32, as the public API's device mode holds it.
The same seed gives the same section.
"""

from __future__ import annotations

import math

import torch

#: genes generated per pass: bounds the float32 temps to [N, 256]
_GENES_A_PASS = 256


def generator(seed: int, device, stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 0x9E3779B97F4A7C15 + stream) % (1 << 63))
    return g


def make(cfg: dict, seed: int, device) -> dict:
    n, G = int(cfg["n_cells"]), int(cfg["n_genes"])
    ext = float(cfg["extent_um"])
    cm = cfg["counts"]
    g = generator(seed, device, 1)
    coords = torch.rand((n, 2), generator=g, device=device) * ext
    rate = torch.exp(cm["log_rate_mean"] + cm["log_rate_sd"]
                     * torch.randn(G, generator=g, device=device))
    every = int(cm["signal_every"])
    theta = torch.rand(G, generator=g, device=device) * (2 * math.pi)
    lo, hi = cm["wavelength_um"]
    wave = lo + (hi - lo) * torch.rand(G, generator=g, device=device)
    phase = torch.rand(G, generator=g, device=device) * (2 * math.pi)
    X = torch.empty((n, G), dtype=torch.float32, device=device)
    for c0 in range(0, G, _GENES_A_PASS):
        c1 = min(c0 + _GENES_A_PASS, G)
        lam = rate[c0:c1].expand(n, c1 - c0).clone()
        sig = torch.arange(c0, c1, device=device) % every == 0
        if bool(sig.any()):
            j = torch.nonzero(sig).flatten()
            u = (coords[:, :1] * torch.cos(theta[c0 + j])
                 + coords[:, 1:] * torch.sin(theta[c0 + j]))
            field = torch.sin(2 * math.pi * u / wave[c0 + j] + phase[c0 + j])
            lam[:, j] *= torch.exp(cm["signal_amp"] * field)
        X[:, c0:c1] = torch.log1p(torch.poisson(lam, generator=g))
        del lam
    return {"coords": coords, "X": X}
