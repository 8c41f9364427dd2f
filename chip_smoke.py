"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without its last line:

1. Device: the card's name and power limit (nvidia-smi), torch's name
   for it and the device count.  No card: exit non-zero.
2. Build: both CUDA kernels from ``src/repro_torch/csrc`` with nvcc, in
   parallel, into ``build/``.
3. Kernel vs plain PyTorch on the card at d=768, h=4096, k=32:
   fused_encode at B=64, B=1000 and an exact-tie case; the sparse-query
   retrieve at Q=64, N=200,003 with duplicate query indices and
   duplicate catalog rows (above the 131,072 items at which the kernel
   seeds its bar from a catalog prefix).
4. The main path: a 1,048,576-item catalog encoded through the encode
   kernel, ``build_index``, then 8 requests of 64 queries through
   ``RetrievalEngine.retrieve_dense`` (top-32), with the launch counts of
   both kernels read around it, the served answers held against the
   plain retrieve, recall@32 against dense brute force, p50/p99 latency
   and peak device memory.
5. Times: each kernel with CUDA events at the main path's shapes, beside
   its bound, its plain version and a one-call PyTorch yardstick.
6. Where the time goes: the retrieve kernel at 1 and 64 queries, top-1
   and top-32; the encode kernel's fp32 rate on a catalog chunk; how many
   query rows a catalog code slot meets; and a ``torch.profiler`` table of
   10 requests, device time by CUDA kernel.

The SAE params are freshly initialised (the port has no training yet).
The line before the last is a JSON object with one entry per kernel; the
last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

D, H, K = 768, 4096, 32           # the paper's widths, SAEConfig's defaults
N_MAIN = 1 << 20                  # main-path catalog
N_CHECK = 200_003                 # ragged catalog of the retrieve check
Q = 64                            # queries per request
REQUESTS = 8
TOPN = 32
NEAR_TIE = 1e-5                   # relative float64 gap below which f32 may reorder
FP32_FLOPS = 67e12                # H100 SXM fp32 outside the tensor cores
HBM_BYTES = 3.35e12               # H100 SXM HBM3


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def gaps(x_norm, w, b):
    """Relative float64 gaps between neighbours of the top k+1 |pre| of each
    row, (B, K): column j is the gap between ranks j and j+1, so column
    K-1 is the k-boundary gap.  Under NEAR_TIE, f32 rounding may swap the
    two neighbours (or, at the boundary, pick the other latent)."""
    pre = x_norm.double() @ w.double() + b.double()
    a = torch.sort(pre.abs(), dim=1, descending=True).values[:, :K + 1]
    return (a[:, :-1] - a[:, 1:]) / a[:, :-1].clamp(min=1e-300)


def compare_codes(kv, ki, pv, pi, rel, what) -> float:
    """Hold kernel codes (kv, ki) against plain codes (pv, pi).  On every
    row whose k-boundary gap is clear: the same latents, and the same
    latent at every rank not inside a near-tied run; values allclose
    (rtol 1e-5, atol 1e-6).  Returns max |dvalue|."""
    clear = rel > NEAR_TIE
    rows = clear[:, K - 1]
    pinned = clear.clone()
    pinned[:, 1:] &= clear[:, :-1]
    pinned &= rows[:, None]
    ks, korder = torch.sort(ki, dim=1)
    ps, porder = torch.sort(pi, dim=1)
    if not torch.equal(ks[rows], ps[rows]):
        bad = int((ks[rows] != ps[rows]).any(dim=1).sum())
        raise AssertionError(f"{what}: {bad} rows with a clear k-boundary choose other latents")
    if not torch.equal(ki[pinned], pi[pinned]):
        raise AssertionError(f"{what}: latents differ at ranks with clear gaps")
    kvs = torch.gather(kv, 1, korder)[rows]
    pvs = torch.gather(pv, 1, porder)[rows]
    torch.testing.assert_close(kvs, pvs, rtol=1e-5, atol=1e-6, msg=what)
    err = float((kvs - pvs).abs().max()) if kvs.numel() else 0.0
    differ = (ki != pi).any(dim=1)
    near = ~clear.all(dim=1)
    if (differ & ~near).any():
        raise AssertionError(f"{what}: codes differ on a row with no near-tie")
    print(f"[check] {what}: {int((~rows).sum())} of {len(rows)} rows under the "
          f"{NEAR_TIE:g} k-boundary gap, {int(near.sum())} with a near-tie in the top "
          f"{K + 1}; indices differ on {int(differ.sum())} rows, all among those; "
          f"max |dvalue| {err:.3e}")
    return err


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    from repro_torch.core import sae
    from repro_torch.core.eval import recall_at_n
    from repro_torch.core.retrieval import build_index, score_dense, top_n
    from repro_torch.core.types import SAEConfig, SparseCodes
    from repro_torch.data.synthetic import clustered_embeddings
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build, launch_counts, reset_launch_counts
    from repro_torch.kernels.fused_encode import fused_encode_chunked
    from repro_torch.kernels.fused_encode.kernel import fused_encode_cuda
    from repro_torch.kernels.fused_encode.ref import fused_encode_ref
    from repro_torch.kernels.sparse_dot.kernel import fused_retrieve_sparse_q_cuda
    from repro_torch.kernels.sparse_dot.ref import retrieve_sparse_q_ref
    from repro_torch.serving import EngineConfig, RetrievalEngine
    from repro_torch.serving.engine import BLOCK_Q

    t_start = time.perf_counter()

    # 1. device
    smi = nvidia_smi()
    dev = resolve_device("cuda:0")
    name = torch.cuda.get_device_name(0)
    print(f"[device] {smi}")
    print(f"[device] torch: {name}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {src}: {line.strip()}")
    print(f"[build] {sorted(logs)} built in {build_s:.1f} s")

    cfg = SAEConfig(d=D, h=H, k=K)
    params = sae.init_params(cfg, torch.Generator(device=dev).manual_seed(1))
    w, b = params["w_enc"], params["b_enc"]

    # 3a. encode kernel vs plain
    enc_err = 0.0
    for B in (64, 1000, 20_000):       # 16-row tiles for the first two, 64-row for the last
        x = sae.normalize_input(clustered_embeddings(
            torch.Generator(device=dev).manual_seed(10 + B), B, d=D))
        kv, ki = fused_encode_cuda(x, w, b, K)
        pv, pi = fused_encode_ref(x, w, b, K)
        enc_err = max(enc_err, compare_codes(kv, ki, pv, pi, gaps(x, w, b),
                                             f"encode B={B}"))
    rng = np.random.default_rng(3)
    wt = torch.tensor(rng.integers(-2, 3, (D, H)).astype(np.float32), device=dev)
    bt = torch.tensor(rng.integers(-1, 2, H).astype(np.float32), device=dev)
    for B in (200, 20_000):
        xt = np.zeros((B, D), np.float32)          # 4 entries of ±1: x̄ = ±0.5 exactly
        cols = np.argsort(rng.random((B, D)), axis=1)[:, :4]
        np.put_along_axis(xt, cols, rng.choice([-1.0, 1.0], (B, 4)).astype(np.float32), 1)
        xt = sae.normalize_input(torch.tensor(xt, device=dev))
        kv, ki = fused_encode_cuda(xt, wt, bt, K)
        pv, pi = fused_encode_ref(xt, wt, bt, K)
        if not (torch.equal(ki, pi) and torch.equal(kv, pv)):
            raise AssertionError(f"encode exact-tie case B={B}: kernel and plain differ")
        print(f"[check] encode exact-tie case B={B}: codes identical (ties to the lowest index)")

    # 3b. retrieve kernel vs plain
    cat = sae.encode_chunked(params, clustered_embeddings(
        torch.Generator(device=dev).manual_seed(20), N_CHECK, d=D), K)
    cv, ci = cat.values.clone(), cat.indices.clone()
    cv[50_000:50_100], ci[50_000:50_100] = cv[:100], ci[:100]   # duplicate rows
    cv[32_764:32_772], ci[32_764:32_772] = cv[:8], ci[:8]       # across the prefix's end
    cv[-1], ci[-1] = cv[3], ci[3]
    index = build_index(SparseCodes(cv, ci, H))
    qc = sae.encode(params, clustered_embeddings(
        torch.Generator(device=dev).manual_seed(21), Q, d=D), K)
    qv, qi = qc.values.clone(), qc.indices.clone()
    qi[:16, 1] = qi[:16, 0]                                     # duplicate query indices
    qv[16:24], qi[16:24] = cv[:8], ci[:8]                       # queries equal to rows 0..7
    args = (index.codes.values, index.codes.indices, index.inv_sparse_norms,
            qv.contiguous(), qi.contiguous(), H)
    sv_k, id_k = fused_retrieve_sparse_q_cuda(*args, TOPN)
    sv_p, id_p = retrieve_sparse_q_ref(*args, n=TOPN)
    if not torch.equal(id_k, id_p):
        bad = int((id_k != id_p).any(dim=1).sum())
        raise AssertionError(f"retrieve N={N_CHECK}: ids differ on {bad} queries")
    torch.testing.assert_close(sv_k, sv_p, rtol=1e-6, atol=0.0)
    for qrow in range(16, 24):
        ids = id_k[qrow].tolist()
        want = [qrow - 16, 32_764 + qrow - 16, 50_000 + qrow - 16]
        if ids[:3] != want:
            raise AssertionError(f"tie order: query {qrow} top-3 {ids[:3]}, expected {want}")
    ret_err = float((sv_k - sv_p).abs().max())
    print(f"[check] retrieve Q={Q} N={N_CHECK} n={TOPN}: ids identical, "
          f"max |dscore| {ret_err:.3e}, duplicate rows tie to the lowest id")
    del cat, cv, ci, index

    # 4. main path
    torch.cuda.reset_peak_memory_stats()
    catalog = clustered_embeddings(torch.Generator(device=dev).manual_seed(0), N_MAIN, d=D)
    reset_launch_counts()
    t0 = time.perf_counter()
    codes = fused_encode_chunked(catalog, w, b, K)
    index = build_index(codes)
    engine = RetrievalEngine(index, params, config=EngineConfig(), device=dev)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    queries, responses, lat = [], [], []
    for r in range(REQUESTS):
        q = clustered_embeddings(torch.Generator(device=dev).manual_seed(1000 + r), Q, d=D)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resp = engine.retrieve_dense(q, TOPN)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        queries.append(q)
        responses.append(resp)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_chunks = -(-N_MAIN // 65536)
    print(f"[main] catalog {N_MAIN} encoded + indexed in {index_s:.2f} s; "
          f"path {responses[0].status.path}; launches {counts}")
    if counts["fused_encode"] < n_chunks + REQUESTS:
        raise AssertionError(f"fused_encode launched {counts['fused_encode']} times, "
                             f"expected >= {n_chunks + REQUESTS}")
    if counts["fused_retrieve_sparse_q"] < REQUESTS:
        raise AssertionError(f"fused_retrieve_sparse_q launched "
                             f"{counts['fused_retrieve_sparse_q']} times, expected >= {REQUESTS}")

    recalls, near_rows = [], 0
    for q, resp in zip(queries, responses):
        if tuple(resp.ids.shape) != (Q, TOPN) or not torch.isfinite(resp.scores).all():
            raise AssertionError("served answer is not finite (Q, n)")
        qp = torch.cat([q, q.new_zeros((-Q) % BLOCK_Q, D)])
        kc = engine.encode_queries(qp)
        pq = engine.prep_query(kc)
        pv_, pid = retrieve_sparse_q_ref(index.codes.values, index.codes.indices,
                                         index.inv_sparse_norms, pq.values, pq.indices,
                                         H, n=TOPN)
        ps = pv_ / pq.norm[:, None].clamp(min=1e-8)
        if not torch.equal(resp.ids, pid[:Q]):
            raise AssertionError("served ids differ from the plain retrieve of the same codes")
        torch.testing.assert_close(resp.scores, ps[:Q], rtol=1e-6, atol=0.0)
        plain = sae.encode(params, q, K)
        rel = gaps(sae.normalize_input(q), w, b)
        compare_codes(kc.values[:Q], kc.indices[:Q], plain.values, plain.indices,
                      rel, "main-path query codes")
        near_rows += int((rel[:, K - 1] <= NEAR_TIE).sum())
        _, true_ids = top_n(score_dense(catalog, q), TOPN)
        recalls.append(recall_at_n(resp.ids, true_ids))
    lat_ms = np.array(lat[1:]) * 1e3
    p50, p99 = float(np.percentile(lat_ms, 50)), float(np.percentile(lat_ms, 99))
    print(f"[main] served ids == plain retrieve on the same codes for all {REQUESTS} "
          f"requests; query rows under the k-boundary gap: {near_rows} of {REQUESTS * Q}")
    print(f"[main] recall@{TOPN} {np.mean(recalls):.4f} vs dense brute force (untrained "
          f"params); latency p50 {p50:.3f} ms p99 {p99:.3f} ms over {REQUESTS - 1} "
          f"requests; peak device memory {peak / 2**30:.2f} GiB")

    # 5. times at the main path's shapes
    xq = sae.normalize_input(queries[0])
    kc = engine.encode_queries(queries[0])
    qv0, qi0 = kc.values.contiguous(), kc.indices.contiguous()
    cand = (index.codes.values, index.codes.indices, index.inv_sparse_norms)
    csr = torch.sparse_csr_tensor(
        torch.arange(0, N_MAIN * K + 1, K, device=dev, dtype=torch.int32), index.codes.indices.reshape(-1),
        index.codes.values.reshape(-1), size=(N_MAIN, H))
    q_dense = torch.zeros(H, Q, device=dev)
    q_dense[qi0.long(), torch.arange(Q, device=dev)[:, None].expand(-1, K)] = qv0
    enc = {
        "ms": cuda_ms(lambda: fused_encode_cuda(xq, w, b, K), 50),
        "plain_ms": cuda_ms(lambda: fused_encode_ref(xq, w, b, K), 50),
        "library_ms": cuda_ms(lambda: torch.matmul(xq, w), 50),
    }
    ret = {
        "ms": cuda_ms(lambda: fused_retrieve_sparse_q_cuda(*cand, qv0, qi0, H, TOPN), 10),
        "plain_ms": cuda_ms(lambda: retrieve_sparse_q_ref(*cand, qv0, qi0, H, n=TOPN), 3, 1),
        "library_ms": cuda_ms(lambda: torch.sparse.mm(csr, q_dense), 10),
    }
    enc_ops, enc_bytes = 2 * Q * D * H, 4 * (Q * D + D * H + H) + 8 * Q * K
    ret_ops, ret_bytes = 2 * Q * N_MAIN * K, 8 * N_MAIN * K + 4 * N_MAIN + 8 * Q * K + 8 * Q * TOPN
    kernels = []
    for kname, src, replaces, t, ops, nbytes, err in (
            ("fused_encode", "src/repro_torch/csrc/fused_encode.cu",
             "src/repro/kernels/fused_encode/kernel.py:76", enc, enc_ops, enc_bytes, enc_err),
            ("fused_retrieve_sparse_q", "src/repro_torch/csrc/sparse_dot.cu",
             "src/repro/kernels/sparse_dot/kernel.py:379", ret, ret_ops, ret_bytes, ret_err)):
        t_ops, t_bytes = ops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[kname], "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": t["library_ms"],
        })
        print(f"[time] {kname}: {t['ms']:.4f} ms (bound {max(t_ops, t_bytes):.4f} ms by "
              f"{kernels[-1]['bound_by']}), plain {t['plain_ms']:.4f} ms, "
              f"library {t['library_ms']:.4f} ms")

    # 6. where the time goes
    for q in (1, Q):
        for n in (1, TOPN):
            ms = cuda_ms(lambda: fused_retrieve_sparse_q_cuda(
                *cand, qv0[:q].contiguous(), qi0[:q].contiguous(), H, n), 10)
            print(f"[profile] retrieve kernel Q={q} n={n}: {ms:.4f} ms")
    xc = sae.normalize_input(catalog[:65536])
    ms = cuda_ms(lambda: fused_encode_cuda(xc, w, b, K), 5)
    print(f"[profile] encode kernel B=65536: {ms:.4f} ms, "
          f"{2 * 65536 * D * H / ms / 1e9:.1f} TFLOP/s")
    held = torch.zeros(H, device=dev)
    for r in range(Q):
        held[qi0[r].long().unique()] += 1
    print(f"[profile] query rows per catalog code slot "
          f"{float(held[index.codes.indices.long()].mean()):.4f}, "
          f"latents held {int((held > 0).sum())}")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            engine.retrieve_dense(queries[0], TOPN)
        torch.cuda.synchronize()
    print("[profile] 10 requests through retrieve_dense, by device time")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(f"[device] {nvidia_smi()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
