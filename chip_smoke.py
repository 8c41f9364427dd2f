"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without its last line:

1. Device: the card's name and power limit (nvidia-smi), torch's name
   for it and the device count.  No card: exit non-zero.
2. Build: both CUDA sources from ``src/repro_torch/csrc`` with nvcc, in
   parallel, into ``build/`` (the encode kernel and the three retrieve
   kernels, one templated body in ``sparse_dot.cu``).
3. Kernel vs plain PyTorch on the card at d=768, h=4096, k=32:
   fused_encode at B=64, B=1000 and an exact-tie case; the three
   sparse-query retrieves (fp32, quantized exact, quantized int8) at
   Q=64, N=200,003 with duplicate query indices and duplicate catalog
   rows (above the 131,072 items at which the kernels seed their bar from
   a catalog prefix, and across the prefix's end), ids and scores
   identical; the quantized kernel identical to the fp32 kernel over the
   dequantized index.  Then the repairs of the first slice: top-n 257 and
   1000, h = 49,152 and 70,000, the encoder at k=128, at h=1000 and at
   h=49,152, and NaN query rows ranked as by the plain path.
4. The main path, three times over one 1,048,576-item catalog encoded
   through the encode kernel: from the fp32 ``SparseIndex``, from the
   ``QuantizedIndex`` at exact and at int8 precision, each 8 requests of
   64 queries through ``RetrievalEngine.retrieve_dense`` (top-32), after
   a collection of the set-up's Python garbage, with
   the launch counts set to 0 just before each path and read just after,
   the served answers held against the plain retrieve of the same codes,
   p50/p99 latency, each request's host time beside the Python GC's time
   in it, the device segments it newly allocated and its retrieve
   kernel's time alone, peak device memory and both indexes' device bytes;
   recall@32 against dense brute force (fp32 path) and int8 recall@32
   against the exact quantized path (printed); then int8 recall@32 >=
   0.95 asserted at N=16,384, Q=64 (d=256, h=1024, k=32).
5. Times: each kernel with CUDA events at the main path's shapes, beside
   its bound, its plain version and a one-call PyTorch yardstick.
6. Where the time goes: the retrieve kernels at 1 and 64 queries, top-1
   and top-32; the encode kernel's fp32 rate on a catalog chunk; how many
   query rows a catalog code slot meets; and a ``torch.profiler`` table of
   10 requests, device time by CUDA kernel.

The SAE params are freshly initialised (the port has no training yet).
The line before the last is a JSON object with one entry per kernel; the
last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
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
N_GATE, D_GATE, H_GATE = 16_384, 256, 1024   # the int8 recall gate's configuration
Q = 64                            # queries per request
REQUESTS = 8
TOPN = 32
NEAR_TIE = 1e-5                   # relative float64 gap below which f32 may reorder
FP32_FLOPS = 67e12                # H100 SXM fp32 outside the tensor cores
INT8_OPS = 1979e12                # H100 SXM int8
HBM_BYTES = 3.35e12               # H100 SXM HBM3
# The main path's three configurations: (path, quantized index, precision).
PATHS = (("fp32", False, "exact"), ("quantized", True, "exact"), ("int8", True, "int8"))
RETRIEVE = {"fp32": "fused_retrieve_sparse_q", "quantized": "fused_retrieve_quantized_sparse_q",
            "int8": "fused_retrieve_quantized_mxu_sparse_q"}


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


def fmt_ms(xs) -> str:
    return "[" + " ".join(f"{x:.3f}" for x in xs) + "]"


class GcClock:
    """A ``gc.callbacks`` hook that adds up the time the collector runs."""

    def __init__(self):
        self.ms = self.t0 = 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self.t0 = time.perf_counter()
        else:
            self.ms += (time.perf_counter() - self.t0) * 1e3


def gaps(x_norm, w, b, k=K):
    """Relative float64 gaps between neighbours of the top k+1 |pre| of each
    row, (B, k): column j is the gap between ranks j and j+1, so column
    k-1 is the k-boundary gap.  Under NEAR_TIE, f32 rounding may swap the
    two neighbours (or, at the boundary, pick the other latent)."""
    pre = x_norm.double() @ w.double() + b.double()
    a = torch.sort(pre.abs(), dim=1, descending=True).values[:, :k + 1]
    return (a[:, :-1] - a[:, 1:]) / a[:, :-1].clamp(min=1e-300)


def compare_codes(kv, ki, pv, pi, rel, what, k=K) -> float:
    """Hold kernel codes (kv, ki) against plain codes (pv, pi).  On every
    row whose k-boundary gap is clear: the same latents, and the same
    latent at every rank not inside a near-tied run; values allclose
    (rtol 1e-5, atol 1e-6).  Returns max |dvalue|."""
    clear = rel > NEAR_TIE
    rows = clear[:, k - 1]
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
          f"{k + 1}; indices differ on {int(differ.sum())} rows, all among those; "
          f"max |dvalue| {err:.3e}")
    return err


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    from repro_torch.core import sae
    from repro_torch.core.eval import recall_at_n, retrieval_quality
    from repro_torch.core.quantized_codes import dequantize_codes
    from repro_torch.core.retrieval import (
        build_index, dequantize_index, index_nbytes, score_dense, top_n,
    )
    from repro_torch.core.types import SAEConfig, SparseCodes
    from repro_torch.data.synthetic import clustered_embeddings
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build, launch_counts, reset_launch_counts
    from repro_torch.kernels.fused_encode import fused_encode_chunked
    from repro_torch.kernels.fused_encode.kernel import fused_encode_cuda
    from repro_torch.kernels.fused_encode.ref import fused_encode_ref
    from repro_torch.kernels.sparse_dot import kernel as sd_kernel
    from repro_torch.kernels.sparse_dot import ref as sd_ref
    from repro_torch.serving import EngineConfig, RetrievalEngine
    from repro_torch.serving.engine import BLOCK_Q

    kernel_fn = {"fp32": sd_kernel.fused_retrieve_sparse_q_cuda,
                 "quantized": sd_kernel.fused_retrieve_quantized_sparse_q_cuda,
                 "int8": sd_kernel.fused_retrieve_quantized_mxu_sparse_q_cuda}
    plain_fn = {"fp32": sd_ref.retrieve_sparse_q_ref,
                "quantized": sd_ref.retrieve_quantized_sparse_q_ref,
                "int8": sd_ref.retrieve_quantized_mxu_sparse_q_ref}

    def cand(index):
        c = index.codes
        if hasattr(c, "values"):
            return c.values, c.indices, index.inv_sparse_norms
        return c.q_values, c.indices, c.scales, index.inv_sparse_norms

    def hold(fmt, index, qv, qi, h, n, what):
        """Kernel vs plain on the same inputs: ids and scores identical."""
        args = (*cand(index), qv, qi, h)
        sk, ik = kernel_fn[fmt](*args, n)
        sp, ip = plain_fn[fmt](*args, n=n)
        if not torch.equal(ik, ip):
            bad = int((ik != ip).any(dim=1).sum())
            raise AssertionError(f"{what}: ids differ on {bad} queries")
        if not torch.equal(sk, sp):
            raise AssertionError(f"{what}: scores differ, max |d| "
                                 f"{float((sk - sp).abs().max()):.3e}")
        return sk, ik

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

    # 3b. the three retrieve kernels vs plain
    cat = sae.encode_chunked(params, clustered_embeddings(
        torch.Generator(device=dev).manual_seed(20), N_CHECK, d=D), K)
    cv, ci = cat.values.clone(), cat.indices.clone()
    cv[50_000:50_100], ci[50_000:50_100] = cv[:100], ci[:100]   # duplicate rows
    cv[32_764:32_772], ci[32_764:32_772] = cv[:8], ci[:8]       # across the prefix's end
    cv[-1], ci[-1] = cv[3], ci[3]
    check_index = {"fp32": build_index(SparseCodes(cv, ci, H))}
    check_index["quantized"] = check_index["int8"] = build_index(SparseCodes(cv, ci, H),
                                                                 quantize=True)
    qc = sae.encode(params, clustered_embeddings(
        torch.Generator(device=dev).manual_seed(21), Q, d=D), K)
    qv, qi = qc.values.clone(), qc.indices.clone()
    qi[:16, 1] = qi[:16, 0]                                     # duplicate query indices
    qv[16:24], qi[16:24] = cv[:8], ci[:8]                       # queries equal to rows 0..7
    qv, qi = qv.contiguous(), qi.contiguous()
    ret_err = {}
    for fmt in ("fp32", "quantized", "int8"):
        sv_k, id_k = hold(fmt, check_index[fmt], qv, qi, H, TOPN, f"retrieve {fmt}")
        if fmt != "int8":
            for qrow in range(16, 24):
                ids = id_k[qrow].tolist()
                want = [qrow - 16, 32_764 + qrow - 16, 50_000 + qrow - 16]
                if ids[:3] != want:
                    raise AssertionError(f"{fmt} tie order: query {qrow} top-3 {ids[:3]}, "
                                         f"expected {want}")
        ret_err[fmt] = 0.0                       # identical, checked above
        print(f"[check] retrieve {fmt} Q={Q} N={N_CHECK} n={TOPN}: ids and scores identical "
              f"to the plain version, duplicate rows tie to the lowest id")
    qs_, qid_ = kernel_fn["quantized"](*cand(check_index["quantized"]), qv, qi, H, TOPN)
    fs_, fid_ = kernel_fn["fp32"](*cand(dequantize_index(check_index["quantized"])),
                                  qv, qi, H, TOPN)
    if not (torch.equal(qid_, fid_) and torch.equal(qs_, fs_)):
        raise AssertionError("quantized kernel differs from the fp32 kernel over "
                             "dequantize_index")
    print("[check] quantized kernel == fp32 kernel over dequantize_index (ids, score bits)")

    # 3c. the repairs of the first slice
    for n in (257, 1000):                         # any n <= N
        for fmt in ("fp32", "quantized", "int8"):
            hold(fmt, check_index[fmt], qv, qi, H, n, f"retrieve {fmt} n={n}")
    print("[check] top-n 257 and 1000 over N=200,003: all three kernels identical to plain")
    del cat, cv, ci, check_index
    for h in (49_152, 70_000):                    # wide latent spaces
        g = torch.Generator(device=dev).manual_seed(h)
        lat = torch.arange(h - 3000, h, device=dev)
        wv = torch.randn(60_001, K, device=dev, generator=g)
        wi = lat[torch.randint(0, 3000, (60_001, K), device=dev, generator=g)].to(torch.int32)
        wq = torch.randn(Q, K, device=dev, generator=g)
        wqi = lat[torch.randint(0, 3000, (Q, K), device=dev, generator=g)].to(torch.int32)
        wide = {"fp32": build_index(SparseCodes(wv, wi, h))}
        wide["quantized"] = wide["int8"] = build_index(SparseCodes(wv, wi, h), quantize=True)
        for fmt in ("fp32", "quantized", "int8"):
            hold(fmt, wide[fmt], wq, wqi, h, TOPN, f"retrieve {fmt} h={h}")
        print(f"[check] h={h} ({wide['quantized'].codes.indices.dtype} indices): all three "
              f"kernels identical to plain")
    for h, k in ((4096, 128), (1000, 32), (49_152, 32)):   # any h >= k >= 1
        p2 = sae.init_params(SAEConfig(d=D, h=h, k=k), torch.Generator(device=dev).manual_seed(h))
        x = sae.normalize_input(clustered_embeddings(
            torch.Generator(device=dev).manual_seed(h + k), Q, d=D))
        kv, ki = fused_encode_cuda(x, p2["w_enc"], p2["b_enc"], k)
        pv, pi = fused_encode_ref(x, p2["w_enc"], p2["b_enc"], k)
        compare_codes(kv, ki, pv, pi, gaps(x, p2["w_enc"], p2["b_enc"], k),
                      f"encode h={h} k={k}", k=k)

    # 4. the main path, once for each index format and precision
    torch.cuda.reset_peak_memory_stats()
    catalog = clustered_embeddings(torch.Generator(device=dev).manual_seed(0), N_MAIN, d=D)
    queries = [clustered_embeddings(torch.Generator(device=dev).manual_seed(1000 + r), Q, d=D)
               for r in range(REQUESTS)]
    n_chunks = -(-N_MAIN // 65536)
    reset_launch_counts()
    t0 = time.perf_counter()
    codes = fused_encode_chunked(catalog, w, b, K)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    results, engines, path_counts = {}, {}, {}
    for path, quantize, precision in PATHS:
        if path != "fp32":
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
        t0 = time.perf_counter()
        index = build_index(codes, quantize=quantize)
        engine = RetrievalEngine(index, params, config=EngineConfig(precision=precision),
                                 device=dev)
        torch.cuda.synchronize()
        index_s = time.perf_counter() - t0
        # Collect the set-up's garbage (the previous path's checks, the
        # index build) before the timed requests: left to the collector, a
        # pass over it fell into a timed request and doubled that request's
        # time.  Per request: the host clock, the Python GC's
        # time inside it and the device segments the caching allocator
        # newly cudaMallocs.
        gc.collect()
        responses, lat, gc_ms, segs = [], [], [], []
        gc_clock = GcClock()
        gc.callbacks.append(gc_clock)
        for q in queries:
            torch.cuda.synchronize()
            gc_clock.ms, seg0 = 0.0, torch.cuda.memory_stats()["segment.all.allocated"]
            t0 = time.perf_counter()
            resp = engine.retrieve_dense(q, TOPN)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            gc_ms.append(gc_clock.ms)
            segs.append(torch.cuda.memory_stats()["segment.all.allocated"] - seg0)
            responses.append(resp)
        gc.callbacks.remove(gc_clock)
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        path_counts[path] = counts
        want_encode = REQUESTS + (n_chunks if path == "fp32" else 0)
        if counts["fused_encode"] < want_encode:
            raise AssertionError(f"{path}: fused_encode launched {counts['fused_encode']} "
                                 f"times, expected >= {want_encode}")
        for kname in RETRIEVE.values():
            want = REQUESTS if kname == RETRIEVE[path] else 0
            if (counts[kname] < want) if want else counts[kname]:
                raise AssertionError(f"{path}: {kname} launched {counts[kname]} times, "
                                     f"expected {'>= ' if want else ''}{want}")
        print(f"[main] {path}: catalog {N_MAIN} "
              + (f"encoded in {encode_s:.2f} s, " if path == "fp32" else "")
              + f"indexed in {index_s:.2f} s; path {responses[0].status.path}; "
              f"launches {counts}")
        near_rows, kernel_ms = 0, []
        for q, resp in zip(queries, responses):
            if tuple(resp.ids.shape) != (Q, TOPN) or not torch.isfinite(resp.scores).all():
                raise AssertionError(f"{path}: served answer is not finite (Q, n)")
            qp = torch.cat([q, q.new_zeros((-Q) % BLOCK_Q, D)])
            kc = engine.encode_queries(qp)
            pq = engine.prep_query(kc)
            pv_, pid = plain_fn[path](*cand(index), pq.values, pq.indices, H, n=TOPN)
            kernel_ms.append(cuda_ms(lambda: kernel_fn[path](
                *cand(index), pq.values, pq.indices, H, TOPN), 5))
            ps = pv_ / pq.norm[:, None].clamp(min=1e-8)
            if not torch.equal(resp.ids, pid[:Q]):
                raise AssertionError(f"{path}: served ids differ from the plain retrieve "
                                     "of the same codes")
            torch.testing.assert_close(resp.scores, ps[:Q], rtol=1e-6, atol=0.0)
            if path == "fp32":
                plain = sae.encode(params, q, K)
                rel = gaps(sae.normalize_input(q), w, b)
                compare_codes(kc.values[:Q], kc.indices[:Q], plain.values, plain.indices,
                              rel, "main-path query codes")
                near_rows += int((rel[:, K - 1] <= NEAR_TIE).sum())
        print(f"[main] {path}: per request (the first is left out of p50/p99): host ms "
              f"{fmt_ms(np.array(lat) * 1e3)}, of it in Python GC {fmt_ms(gc_ms)}, new "
              f"device segments {segs}; the retrieve kernel alone on the request's codes "
              f"(CUDA events) {fmt_ms(kernel_ms)}")
        lat_ms = np.array(lat[1:]) * 1e3
        results[path] = {"p50": float(np.percentile(lat_ms, 50)),
                         "p99": float(np.percentile(lat_ms, 99)), "peak": peak,
                         "index_bytes": index_nbytes(index), "responses": responses}
        engines[path] = engine
        print(f"[main] {path}: served ids == plain retrieve on the same codes for all "
              f"{REQUESTS} requests" + (f"; query rows under the k-boundary gap: "
                                        f"{near_rows} of {REQUESTS * Q}" if path == "fp32" else ""))
        if path == "fp32":
            recalls = [recall_at_n(r.ids, top_n(score_dense(catalog, q), TOPN)[1])
                       for q, r in zip(queries, responses)]
            print(f"[main] fp32: recall@{TOPN} {np.mean(recalls):.4f} vs dense brute force "
                  "(untrained params)")
        if path == "int8":
            vs = retrieval_quality(
                (torch.cat([r.scores for r in responses]), torch.cat([r.ids for r in responses])),
                (torch.cat([r.scores for r in results["quantized"]["responses"]]),
                 torch.cat([r.ids for r in results["quantized"]["responses"]])))
            print(f"[main] int8: recall@{TOPN} vs the exact quantized path at N={N_MAIN} "
                  f"{vs['recall']:.4f} (printed, not gated), score MAE {vs['score_mae']:.3e}, "
                  f"rank displacement {vs['rank_displacement']:.3f}")
        print(f"[main] {path}: latency p50 {results[path]['p50']:.3f} ms p99 "
              f"{results[path]['p99']:.3f} ms over {REQUESTS - 1} requests; peak device "
              f"memory {peak / 2**30:.2f} GiB")
    fp_b, q_b = results["fp32"]["index_bytes"], results["quantized"]["index_bytes"]
    q_codes, f_codes = engines["quantized"].index.codes, engines["fp32"].index.codes
    print(f"[index] device bytes at N={N_MAIN}: fp32 SparseIndex {fp_b / 2**20:.1f} MiB, "
          f"QuantizedIndex {q_b / 2**20:.1f} MiB ({q_b / fp_b:.1%}); codes alone "
          f"(nbytes_logical) {q_codes.nbytes_logical / f_codes.nbytes_logical:.1%}, the "
          f"JAX package's 39.1%")

    # A4: NaN query rows rank on the kernel path as on the plain path
    xn = queries[0][:8].clone()
    xn[0] = float("nan")
    xn[1, 3] = float("nan")
    for path, _, precision in PATHS:
        fast = engines[path]
        slow = RetrievalEngine(fast.index, params, config=EngineConfig(
            precision=precision, use_kernel=False), device=dev)
        kc, pc = fast.encode_queries(xn), slow.encode_queries(xn)
        if not (torch.equal(kc.indices[:2], pc.indices[:2])
                and kc.indices[:2].tolist() == [list(range(K))] * 2):
            raise AssertionError(f"{path}: NaN rows encode to other latents")
        got, want = fast.retrieve_codes(kc, TOPN), slow.retrieve_codes(kc, TOPN)
        if not (torch.equal(got[1], want[1]) and torch.isnan(got[0][:2]).all()):
            raise AssertionError(f"{path}: NaN rows rank otherwise on the kernel path")
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=0, equal_nan=True)
    print("[check] NaN query rows: kernel path ids == plain path ids on all three paths "
          "(NaN above every number, lowest id first)")

    # the int8 recall gate's configuration, through the kernels
    pg = sae.init_params(SAEConfig(d=D_GATE, h=H_GATE, k=K),
                         torch.Generator(device=dev).manual_seed(0))
    corpus = clustered_embeddings(torch.Generator(device=dev).manual_seed(1), N_GATE, d=D_GATE)
    qg = clustered_embeddings(torch.Generator(device=dev).manual_seed(2), Q, d=D_GATE)
    gidx = build_index(fused_encode_chunked(corpus, pg["w_enc"], pg["b_enc"], K), quantize=True)
    e = RetrievalEngine(gidx, pg, device=dev).retrieve_dense(qg, TOPN)
    a = RetrievalEngine(gidx, pg, config=EngineConfig(precision="int8"),
                        device=dev).retrieve_dense(qg, TOPN)
    gate = retrieval_quality(a, e)
    if gate["recall"] < 0.95:
        raise AssertionError(f"int8 recall@{TOPN} {gate['recall']:.4f} < 0.95 at N={N_GATE}")
    print(f"[check] int8 recall@{TOPN} vs exact quantized at N={N_GATE}, Q={Q}, d={D_GATE}, "
          f"h={H_GATE}: {gate['recall']:.4f} >= 0.95 (score MAE {gate['score_mae']:.3e})")
    del corpus, gidx

    # 5. times at the main path's shapes
    xq = sae.normalize_input(queries[0])
    kc = engines["fp32"].encode_queries(queries[0])
    qv0, qi0 = kc.values.contiguous(), kc.indices.contiguous()
    held = torch.zeros(H, device=dev)
    for r in range(Q):
        held[qi0[r].long().unique()] += 1
    pairs = float(held[f_codes.indices.long()].sum())   # (slot, query row) products
    enc = {
        "ms": cuda_ms(lambda: fused_encode_cuda(xq, w, b, K), 50),
        "plain_ms": cuda_ms(lambda: fused_encode_ref(xq, w, b, K), 50),
        "library_ms": cuda_ms(lambda: torch.matmul(xq, w), 50),
    }
    q_dense = torch.zeros(H, Q, device=dev)
    q_dense[qi0.long(), torch.arange(Q, device=dev)[:, None].expand(-1, K)] = qv0
    rowptr = torch.arange(0, N_MAIN * K + 1, K, device=dev, dtype=torch.int32)
    csr = torch.sparse_csr_tensor(rowptr, f_codes.indices.reshape(-1),
                                  f_codes.values.reshape(-1), size=(N_MAIN, H))
    deq = dequantize_codes(q_codes)
    csr_q = torch.sparse_csr_tensor(rowptr, deq.indices.reshape(-1), deq.values.reshape(-1),
                                    size=(N_MAIN, H))
    library = {"fp32": lambda: torch.sparse.mm(csr, q_dense),
               "quantized": lambda: torch.sparse.mm(csr_q, q_dense), "int8": None}
    io_bytes = 8 * Q * K + 8 * Q * TOPN
    enc_ops, enc_bytes = 2 * Q * D * H, 4 * (Q * D + D * H + H) + 8 * Q * K
    entries = [("fused_encode", "src/repro_torch/csrc/fused_encode.cu",
                "src/repro/kernels/fused_encode/kernel.py:76", enc, enc_ops / FP32_FLOPS,
                enc_bytes, enc_err, path_counts["fp32"]["fused_encode"])]
    for path, replaces, row_bytes, ops_s in (
            ("fp32", "src/repro/kernels/sparse_dot/kernel.py:379", 8 * K + 4,
             2 * pairs / FP32_FLOPS),
            ("quantized", "src/repro/kernels/sparse_dot/kernel.py:550", 3 * K + 8,
             (2 * pairs + N_MAIN * K) / FP32_FLOPS),
            ("int8", "src/repro/kernels/sparse_dot/kernel.py:755", 3 * K + 8,
             2 * pairs / INT8_OPS)):
        args = cand(engines[path].index)
        t = {"ms": cuda_ms(lambda: kernel_fn[path](*args, qv0, qi0, H, TOPN), 10),
             "plain_ms": cuda_ms(lambda: plain_fn[path](*args, qv0, qi0, H, n=TOPN), 3, 1),
             "library_ms": (None if library[path] is None
                            else cuda_ms(library[path], 10))}
        entries.append((RETRIEVE[path], "src/repro_torch/csrc/sparse_dot.cu", replaces, t,
                        ops_s, N_MAIN * row_bytes + io_bytes, ret_err[path],
                        path_counts[path][RETRIEVE[path]]))
    kernels = []
    for kname, src, replaces, t, t_ops_s, nbytes, err, launches in entries:
        t_ops, t_bytes = t_ops_s * 1e3, nbytes / HBM_BYTES * 1e3
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": t["library_ms"],
        })
        lib_txt = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        print(f"[time] {kname}: {t['ms']:.4f} ms (bound {max(t_ops, t_bytes):.4f} ms by "
              f"{kernels[-1]['bound_by']}), plain {t['plain_ms']:.4f} ms, library {lib_txt}")
    del csr, csr_q, deq, q_dense

    # 6. where the time goes
    for path in ("fp32", "quantized", "int8"):
        args = cand(engines[path].index)
        for q in (1, Q):
            for n in (1, TOPN):
                ms = cuda_ms(lambda: kernel_fn[path](
                    *args, qv0[:q].contiguous(), qi0[:q].contiguous(), H, n), 10)
                print(f"[profile] retrieve {path} kernel Q={q} n={n}: {ms:.4f} ms")
    xc = sae.normalize_input(catalog[:65536])
    ms = cuda_ms(lambda: fused_encode_cuda(xc, w, b, K), 5)
    print(f"[profile] encode kernel B=65536: {ms:.4f} ms, "
          f"{2 * 65536 * D * H / ms / 1e9:.1f} TFLOP/s")
    print(f"[profile] query rows per catalog code slot {pairs / (N_MAIN * K):.4f}, "
          f"latents held {int((held > 0).sum())}")
    for path in ("fp32", "quantized", "int8"):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                engines[path].retrieve_dense(queries[0], TOPN)
            torch.cuda.synchronize()
        print(f"[profile] {path}: 10 requests through retrieve_dense, by device time")
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12))
    for path in ("fp32", "quantized", "int8"):
        r = results[path]
        print(f"[summary] {path}: p50 {r['p50']:.3f} ms p99 {r['p99']:.3f} ms, peak "
              f"{r['peak'] / 2**30:.2f} GiB, index {r['index_bytes'] / 2**20:.1f} MiB")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(f"[device] {nvidia_smi()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
