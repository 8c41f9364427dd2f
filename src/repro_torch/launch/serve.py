"""Retrieval serving entry point of the port (twin of ``repro.launch.serve``
for the default request).

Builds a compressed index over a synthetic catalog made on the device,
constructs a ``RetrievalEngine`` and serves batched dense requests
through ``engine.retrieve_dense(x, n)``.  On a CUDA device both the
catalog encode and every request run the hand-written kernels
(fused_encode, then fused_retrieve_sparse_q); ``--device cpu`` runs the
plain PyTorch path.  The port has no training yet, so the SAE params are
freshly initialised (the JAX ``init_params``: tied, unit-norm decoder
rows): the same kernels run at the same widths, and recall is that of an
untrained encoder.

    PYTHONPATH=src python -m repro_torch.launch.serve --catalog 100000 --requests 8 --batch 64 --topn 32 --device cuda

Prints an ``[index]`` line (dense vs compressed bytes) and one
``[serve]`` line: the path (fused-kernel or torch-plain), recall@n
against brute-force dense cosine, p50/p99 request latency on the host
clock around a device synchronize (the first request left out), and each
kernel's launch count.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.core.eval import recall_at_n
from repro_torch.core.retrieval import build_index, kernel_path, score_dense, top_n
from repro_torch.core.sae import init_params
from repro_torch.core.types import SAEConfig
from repro_torch.data.synthetic import clustered_embeddings
from repro_torch.device import resolve_device
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.fused_encode import fused_encode_chunked
from repro_torch.serving import EngineConfig, RetrievalEngine


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Serve the default sparse-mode request (d=768, h=4096, "
                    "k=32) from a synthetic catalog.  The SAE params are "
                    "freshly initialised (tied, unit-norm decoder rows): the "
                    "port has no training yet.")
    ap.add_argument("--catalog", type=int, default=100000)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--topn", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; raises without a card) or cpu "
                         "(the plain PyTorch path)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.requests < 2:
        ap.error("--requests must be >= 2: the first request is left out of "
                 "the latency percentiles")

    dev = resolve_device(args.device)
    cfg = SAEConfig()
    catalog = clustered_embeddings(
        torch.Generator(device=dev).manual_seed(args.seed), args.catalog, d=cfg.d)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed + 1))
    path = "fused-kernel" if kernel_path("auto", dev) else "torch-plain"

    reset_launch_counts()
    codes = fused_encode_chunked(catalog, params["w_enc"], params["b_enc"], cfg.k)
    index = build_index(codes)
    dense_bytes = args.catalog * cfg.d * 4
    print(f"[index] {args.catalog} items ({cfg.d}->{cfg.h}, k={cfg.k}) on {dev}: "
          f"dense {dense_bytes / 2**20:.1f} MiB -> compressed "
          f"{codes.nbytes_logical / 2**20:.1f} MiB "
          f"({dense_bytes / codes.nbytes_logical:.1f}x)")

    engine = RetrievalEngine(index, params, config=EngineConfig(), device=dev)
    lat, recalls = [], []
    for r in range(args.requests):
        q = clustered_embeddings(
            torch.Generator(device=dev).manual_seed(1000 + args.seed + r),
            args.batch, d=cfg.d)
        _sync(dev)
        t0 = time.perf_counter()
        resp = engine.retrieve_dense(q, args.topn)
        _sync(dev)
        lat.append(time.perf_counter() - t0)
        _, true_ids = top_n(score_dense(catalog, q), args.topn)
        recalls.append(recall_at_n(resp.ids, true_ids))
    lat_ms = np.array(lat[1:]) * 1e3
    counts = launch_counts()
    print(f"[serve] path={path} device={dev} recall@{args.topn} "
          f"{np.mean(recalls):.4f} | latency p50 {np.percentile(lat_ms, 50):.3f} ms "
          f"p99 {np.percentile(lat_ms, 99):.3f} ms over {args.requests - 1} "
          f"requests (first left out) | launches "
          + " ".join(f"{name}={c}" for name, c in counts.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
