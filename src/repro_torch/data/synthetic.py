"""Synthetic catalog embeddings (twin of ``clustered_embeddings`` in
``repro.data.synthetic``).

The same distribution as the JAX generator: clustered, with a decaying
spectrum and heavy-tailed cluster sizes.  The numbers differ (another
RNG).  The generator's device is where the data is made, so a
full-size catalog never crosses the host.
"""
from __future__ import annotations

import torch


def clustered_embeddings(
    generator: torch.Generator,
    n: int,
    d: int = 768,
    n_clusters: int = 64,
    spectrum_decay: float = 0.65,
    noise: float = 0.35,
    zipf_a: float = 1.2,
) -> torch.Tensor:
    """(n, d) float32 embeddings with clustered, spectrally-decaying structure."""
    dev = generator.device
    g = dict(generator=generator, device=dev)
    spectrum = spectrum_decay ** (torch.arange(d, device=dev) / (d / 8.0))
    centroids = torch.randn(n_clusters, d, **g) * spectrum
    u = torch.rand(n, **g) * (1.0 - 1e-6) + 1e-6
    assign = torch.clamp(u ** (-1.0 / zipf_a) - 1.0, 0, n_clusters - 1).long()
    x = centroids[assign] + noise * torch.randn(n, d, **g) * spectrum
    return x * torch.exp(0.1 * torch.randn(n, 1, **g))
