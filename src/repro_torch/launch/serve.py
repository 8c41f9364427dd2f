"""Retrieval serving entry point of the port (twin of ``repro.launch.serve``
for sparse mode on one device).

Builds a compressed index over a synthetic catalog made on the device,
constructs a ``RetrievalEngine`` and serves batched dense requests
through ``engine.retrieve_dense(x, n)``.  On a CUDA device both the
catalog encode and every request run the hand-written kernels
(fused_encode, then the retrieve of the index's format); ``--device cpu``
runs the plain PyTorch path.  The port has no training yet, so the SAE params are
freshly initialised (the JAX ``init_params``: tied, unit-norm decoder
rows): the same kernels run at the same widths, and recall is that of an
untrained encoder.

    PYTHONPATH=src python -m repro_torch.launch.serve --catalog 100000 --requests 8 --batch 64 --topn 32 --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --catalog 100000 --quantized
    PYTHONPATH=src python -m repro_torch.launch.serve --catalog 100000 --quantized --precision int8

``--quantized`` serves from a ``QuantizedIndex`` (int8 values, int16
indices, f32 row scales stay so on the device; exact, identical to
serving the dequantized index); ``--precision int8`` (needs
``--quantized``) scores in int8, an approximate path whose recall@n
against the same engine at exact precision is printed live.

Prints ``[index]`` lines (dense vs compressed bytes, and the bytes the
index holds on its device) and one ``[serve]`` line: the path, recall@n
against brute-force dense cosine, the int8-vs-exact recall@n where
scoring is int8, p50/p99 request latency on the host clock around a
device synchronize (the first request left out), and each kernel's
launch count.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.core.eval import recall_at_n
from repro_torch.core.retrieval import build_index, index_nbytes, score_dense, top_n
from repro_torch.core.sae import init_params
from repro_torch.core.types import SAEConfig
from repro_torch.data.synthetic import clustered_embeddings
from repro_torch.device import resolve_device
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.fused_encode import fused_encode_chunked
from repro_torch.serving import EngineConfig, RetrievalEngine, path_name


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Serve sparse-mode requests (d=768, h=4096, k=32) from a "
                    "synthetic catalog.  The SAE params are "
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
    ap.add_argument("--quantized", action="store_true",
                    help="serve from the int8/int16 QuantizedIndex")
    ap.add_argument("--precision", choices=("exact", "int8"), default="exact",
                    help="int8: approximate int8 x int8 scoring (needs --quantized)")
    args = ap.parse_args(argv)
    if args.precision == "int8" and not args.quantized:
        ap.error("--precision int8 requires --quantized")
    if args.requests < 2:
        ap.error("--requests must be >= 2: the first request is left out of "
                 "the latency percentiles")

    dev = resolve_device(args.device)
    cfg = SAEConfig()
    catalog = clustered_embeddings(
        torch.Generator(device=dev).manual_seed(args.seed), args.catalog, d=cfg.d)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed + 1))

    reset_launch_counts()
    codes = fused_encode_chunked(catalog, params["w_enc"], params["b_enc"], cfg.k)
    index = build_index(codes, quantize=args.quantized)
    dense_bytes = args.catalog * cfg.d * 4
    stored = index.codes.nbytes_logical
    print(f"[index] {args.catalog} items ({cfg.d}->{cfg.h}, k={cfg.k}) on {dev}: "
          f"dense {dense_bytes / 2**20:.1f} MiB -> compressed "
          f"{stored / 2**20:.1f} MiB ({dense_bytes / stored:.1f}x)")
    print(f"[index] serving format: {type(index).__name__} "
          f"({index.codes.q_values.dtype if args.quantized else index.codes.values.dtype}"
          f"/{index.codes.indices.dtype}), {index_nbytes(index) / 2**20:.1f} MiB on "
          f"{dev} with norms and reciprocals")

    engine = RetrievalEngine(index, params, config=EngineConfig(precision=args.precision),
                             device=dev)
    # int8 scoring is approximate: its live quality is measured against
    # the same index served at exact precision.
    exact = (RetrievalEngine(index, params, config=EngineConfig(), device=dev)
             if args.precision == "int8" else None)
    lat, served = [], []
    for r in range(args.requests):
        q = clustered_embeddings(
            torch.Generator(device=dev).manual_seed(1000 + args.seed + r),
            args.batch, d=cfg.d)
        _sync(dev)
        t0 = time.perf_counter()
        resp = engine.retrieve_dense(q, args.topn)
        _sync(dev)
        lat.append(time.perf_counter() - t0)
        served.append((q, resp))
    # read before the exact comparisons, so the counts are the served path's
    counts = launch_counts()
    recalls = [recall_at_n(resp.ids, top_n(score_dense(catalog, q), args.topn)[1])
               for q, resp in served]
    vs_exact = ([] if exact is None else
                [recall_at_n(resp.ids, exact.retrieve_dense(q, args.topn).ids)
                 for q, resp in served])
    lat_ms = np.array(lat[1:]) * 1e3
    quality = (f" | int8-vs-exact recall@{args.topn} {np.mean(vs_exact):.4f}"
               if vs_exact else "")
    print(f"[serve] path={path_name(engine)} device={dev} recall@{args.topn} "
          f"{np.mean(recalls):.4f}{quality} | latency p50 {np.percentile(lat_ms, 50):.3f} ms "
          f"p99 {np.percentile(lat_ms, 99):.3f} ms over {args.requests - 1} "
          f"requests (first left out) | launches "
          + " ".join(f"{name}={c}" for name, c in counts.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
