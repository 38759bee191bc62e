#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card and exits non-zero
without one.  Phases, each printing one JSON line (any failure exits
non-zero before the final line):

  1. device   — the card's name and power limit (nvidia-smi), torch and
                CUDA versions; TF32 off for matmuls and cuDNN.
  2. build    — compile every kernel of the serving paths from the sources
                in the checkout (``repro_torch/csrc``), one nvcc per source,
                all started together.
  3. kernel   — the paged-attention kernel (K1) against its plain PyTorch
                version on the card at the serving shapes (B 8, J 5, G 3, N
                64, page 16, M 64, ragged lengths 1..1024), f32 (tolerance
                2e-5) and bf16 (2e-2); median times of 50 cold-L2 launches
                of the kernel, the plain version and
                scaled_dot_product_attention on the gathered view (a
                yardstick only: the port never calls it), and the bound:
                bytes moved at 3.35 TB/s.
  4. kernel-int8 — the int8-pool kernel (K2) the same way, on int8 pages
                with f32 scales quantized from random K/V; its yardstick is
                SDPA over the gathered view already dequantized.
  5. serve    — SmolLM-360M at full width in bf16, random weights from a
                seed, 16 requests (prompts 64..512 tokens, half sharing a
                256-token prefix, 32..64 new tokens) through the port's
                PagedEngine; the launch counts are zeroed just before and
                K1's must equal decode steps x 32 layers just after.
  6. profile  — the same bf16 engine with every slot filled (prompts of
                64..512 tokens), once with the kernel and once with the plain
                gather path: host ms per decode step, then ``torch.profiler``
                over 10 steps for device ms per step by kernel, kernel
                launches per step and the device's busy share of the wall.
  7. exact    — SmolLM-360M at full width, 4 layers, f32: greedy tokens of
                8 requests with the kernel and with the plain gather path
                must be identical.
  8. serve-int8 — SmolLM-360M at full width and depth in bf16 with int8 KV
                pages and the host-memory cold tier (256 pages) over a pool
                smaller than full residency: three waves of 8 requests (a
                shared 256-token prefix, unrelated prompts, the shared
                prefix again), so the first wave's cached prefix pages are
                spilled by the second and faulted back by the third.  K2's
                launches must equal decode steps x 32 and K1's be 0; spills
                and faults above 0, every staging task done and every cold
                entry in host memory.
  9. profile-int8 — the profile phase's kernel run with int8 pages.
 10. exact-int8 — SmolLM-360M at full width, 4 layers, f32, int8 pages:
                greedy tokens with K2 and with the plain path identical, and
                a tight pool with the cold tier (spills and faults above 0)
                identical to a full-residency pool.

Then the card line, the kernels line and, last, the ``ok`` line.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
KV_SHAPE = dict(B=8, J=5, G=3, N=64, page=16, M=64)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------------
# 3-4. kernels against their plain versions
# ----------------------------------------------------------------------------

def _median_ms(torch, fn, reps=50):
    """Median device time of ``fn`` over ``reps`` launches, each timed with
    CUDA events after a write of 256 MB that evicts the 50 MB L2 (decode
    reads a layer's pool cold)."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    fn()                                                     # warm up
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def _serving_table(torch, np):
    """Block table and ragged lengths (1..1024) of the kernel phases: every
    row owns M distinct pages of a pool of P = B * M + 1."""
    B, M, page = KV_SHAPE["B"], KV_SHAPE["M"], KV_SHAPE["page"]
    rng = np.random.default_rng(0)
    lengths_np = np.sort(rng.integers(1, M * page + 1, B))
    lengths_np[0], lengths_np[-1] = 1, M * page              # ragged 1..1024
    P = B * M + 1
    table_np = rng.permutation(np.arange(1, P)).reshape(B, M).astype(np.int32)
    table = torch.from_numpy(table_np).cuda()
    lengths = torch.from_numpy(lengths_np.astype(np.int32)).cuda()
    return lengths_np, P, table, lengths


def _bound(np, lengths_np, q, dtype_name, value_bytes, scale_bytes):
    """Least time for one launch at these inputs: K and V of the live
    entries (values and scales) read once, q read and the output written
    once, the table entries and lengths read; QK^T and PV at the peak rate
    of q's type."""
    B, J, G, N, page, M = (KV_SHAPE[k] for k in "B J G N page M".split())
    live = int(np.minimum(lengths_np, M * page).sum())
    pages_read = int(np.minimum(-(-lengths_np // page), M).sum())
    nbytes = (2 * live * J * (N * value_bytes + scale_bytes)
              + 2 * q.numel() * q.element_size()
              + 4 * pages_read + 4 * B)
    flops = 4 * live * J * G * N
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def _sdpa_view(torch, kg, vg, q, lengths):
    """Arguments of scaled_dot_product_attention over a gathered (B, T, J,
    N) view: the GQA heads repeated, the dead tail masked."""
    B, J, G, N = q.shape
    T = kg.shape[1]
    kg = kg.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()
    vg = vg.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()
    mask = (torch.arange(T, device="cuda")[None, :]
            < lengths[:, None].long())[:, None, None, :]
    return q.reshape(B, J * G, 1, N), kg, vg, mask


def kernel_phase(torch, np, ops, ref):
    """The kernel against its plain version at the serving shapes."""
    import torch.nn.functional as F

    B, J, G, N, page, M = (KV_SHAPE[k] for k in "B J G N page M".split())
    lengths_np, P, table, lengths = _serving_table(torch, np)
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        q = (torch.randn(B, J, G, N, generator=gen, device="cuda")
             * N ** -0.5).to(dtype)
        kp = torch.randn(P, page, J, N, generator=gen, device="cuda").to(dtype)
        vp = torch.randn(P, page, J, N, generator=gen, device="cuda").to(dtype)
        out = ops.paged_attention(q, kp, vp, table, lengths)
        plain = ref.paged_attention_ref(q, kp, vp, table, lengths)
        torch.cuda.synchronize()
        err = float((out.float() - plain.float()).abs().max())
        if not err <= TOL[dtype_name]:
            raise AssertionError(f"paged_attention {dtype_name}: max abs "
                                 f"err {err} > {TOL[dtype_name]}")

        # The library yardstick: SDPA over the gathered logical view.
        T = M * page
        qh, kg, vg, mask = _sdpa_view(
            torch, kp[table].reshape(B, T, J, N),
            vp[table].reshape(B, T, J, N), q, lengths)
        lib = F.scaled_dot_product_attention(qh, kg, vg, attn_mask=mask,
                                             scale=1.0)
        lib_err = float((lib.reshape(B, J, G, N).float()
                         - plain.float()).abs().max())
        results[dtype_name] = {
            "dtype": dtype_name, "max_abs_err": err,
            "tolerance": TOL[dtype_name], "library_max_abs_err": lib_err,
            "ms": _median_ms(torch, lambda: ops.paged_attention(
                q, kp, vp, table, lengths)),
            "plain_ms": _median_ms(torch, lambda: ref.paged_attention_ref(
                q, kp, vp, table, lengths)),
            "library_ms": _median_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kg, vg, attn_mask=mask, scale=1.0)),
            **_bound(np, lengths_np, q, dtype_name, q.element_size(), 0),
        }
    torch.cuda.synchronize()
    return {"shape": dict(KV_SHAPE, P=P, lengths=lengths_np.tolist()),
            "checks": results}


def quant_kernel_phase(torch, np, ops, ref, kv_quantize, kv_dequantize):
    """The int8-pool kernel against its plain version at the serving
    shapes: K/V drawn in f32 and quantized with the port's own
    ``kv_quantize``."""
    import torch.nn.functional as F

    B, J, G, N, page, M = (KV_SHAPE[k] for k in "B J G N page M".split())
    lengths_np, P, table, lengths = _serving_table(torch, np)
    gen = torch.Generator(device="cuda").manual_seed(1)
    results = {}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        q = (torch.randn(B, J, G, N, generator=gen, device="cuda")
             * N ** -0.5).to(dtype)
        kp, ksc = kv_quantize(torch.randn(P, page, J, N, generator=gen,
                                          device="cuda"))
        vp, vsc = kv_quantize(torch.randn(P, page, J, N, generator=gen,
                                          device="cuda"))
        args = (q, kp, vp, ksc, vsc, table, lengths)
        out = ops.paged_attention_quant(*args)
        plain = ref.paged_attention_quant_ref(*args)
        torch.cuda.synchronize()
        err = float((out.float() - plain.float()).abs().max())
        if not err <= TOL[dtype_name]:
            raise AssertionError(f"paged_attention_quant {dtype_name}: max "
                                 f"abs err {err} > {TOL[dtype_name]}")

        # The library yardstick: SDPA over the gathered view, dequantized
        # to q's dtype before timing (the dequantization is not timed).
        T = M * page
        qh, kg, vg, mask = _sdpa_view(
            torch,
            kv_dequantize(kp[table].reshape(B, T, J, N),
                          ksc[table].reshape(B, T, J)).to(dtype),
            kv_dequantize(vp[table].reshape(B, T, J, N),
                          vsc[table].reshape(B, T, J)).to(dtype), q, lengths)
        lib = F.scaled_dot_product_attention(qh, kg, vg, attn_mask=mask,
                                             scale=1.0)
        lib_err = float((lib.reshape(B, J, G, N).float()
                         - plain.float()).abs().max())
        results[dtype_name] = {
            "dtype": dtype_name, "max_abs_err": err,
            "tolerance": TOL[dtype_name], "library_max_abs_err": lib_err,
            "ms": _median_ms(torch, lambda: ops.paged_attention_quant(*args)),
            "plain_ms": _median_ms(
                torch, lambda: ref.paged_attention_quant_ref(*args)),
            "library_ms": _median_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kg, vg, attn_mask=mask, scale=1.0)),
            "library": "scaled_dot_product_attention on the dequantized "
                       "gathered view",
            **_bound(np, lengths_np, q, dtype_name, 1, 4),
        }
    torch.cuda.synchronize()
    return {"shape": dict(KV_SHAPE, P=P, lengths=lengths_np.tolist()),
            "checks": results}


# ----------------------------------------------------------------------------
# 5. serve SmolLM-360M at full width
# ----------------------------------------------------------------------------

def _requests(np, vocab, n, seed, prefix_len, lo, hi, new_lo, new_hi):
    """``n`` prompts of ``lo..hi`` tokens, the even ones sharing a
    ``prefix_len``-token prefix, with ``new_lo..new_hi`` new tokens each."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, prefix_len)
    out = []
    for i in range(n):
        L = int(rng.integers(max(lo, prefix_len + 1) if i % 2 == 0 else lo,
                             hi + 1))
        body = rng.integers(0, vocab, L)
        if i % 2 == 0:
            body[:prefix_len] = prefix
        out.append((body.astype(np.int32), int(rng.integers(new_lo,
                                                            new_hi + 1))))
    return out


def _run_waves(eng, waves):
    """Submit each wave once the one before has finished."""
    rids = []
    for wave in waves:
        rids += [eng.submit(p, n) for p, n in wave]
        eng.run()
    return rids


def serve_config(ServeConfig):
    """The serving configuration of every engine phase: 8 slots of 1024
    tokens, pages of 16, full-residency pool, prefix cache on, no cold tier,
    greedy."""
    return ServeConfig(max_batch=8, max_seq_len=1024, page_size=16,
                       num_pages=0, prefix_cache=True, cold_pages=0,
                       temperature=0.0, engine_mode="paged")


def _serve(torch, np, ops, cfg, model, scfg, waves, ExecPolicy,
           PagedEngine):
    """Serve ``waves`` of (prompt, new tokens) through a fresh kernel-path
    engine, each wave submitted once the one before has finished, after a
    warm-up on an engine of its own (CUDA context, cuBLAS handles).  Both
    launch counts are zeroed just before the waves and read just after.
    Returns the open engine, the metrics and the counts (K1, K2)."""
    reqs = [r for wave in waves for r in wave]
    warm = PagedEngine(cfg, model, scfg, ExecPolicy(use_kernel=True))
    warm.generate([reqs[0][0][:64]], 2)
    warm.close()
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    eng = PagedEngine(cfg, model, scfg, ExecPolicy(use_kernel=True))
    decode_s = []
    inner = eng.backend.decode_step

    def timed_decode():
        t = time.perf_counter()
        toks = inner()                     # ends in the token readback
        decode_s.append(time.perf_counter() - t)
        return toks

    eng.backend.decode_step = timed_decode
    ops.launches = ops.quant_launches = 0  # zeroed just before the main path
    t0 = time.perf_counter()
    rids = _run_waves(eng, waves)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (ops.launches, ops.quant_launches)          # read just after
    results = [eng.result(r) for r in rids]
    stats = eng.stats()
    for (prompt, n), res in zip(reqs, results):
        toks = res["tokens"]
        if "error" in res or len(toks) != n:
            raise AssertionError(f"request {res['rid']}: {len(toks)} of {n} "
                                 f"tokens, {res.get('error')}")
        if not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {res['rid']}: token out of range")
    new_tokens = sum(len(r["tokens"]) for r in results)
    out = {
        "arch": cfg.arch_id, "dtype": cfg.dtype, "layers": cfg.num_layers,
        "requests": len(reqs), "new_tokens": new_tokens,
        "prompt_tokens": int(sum(len(p) for p, _ in reqs)),
        "wall_s": wall, "tok_per_s": new_tokens / wall,
        "mean_ttft_ms": 1e3 * float(np.mean([r["ttft_s"] for r in results])),
        "decode_steps": stats["steps"],
        "decode_ms_per_step": 1e3 * float(np.mean(decode_s)),
        "decode_ms_per_step_median": 1e3 * float(np.median(decode_s)),
        "prefix_hit_pages": stats["kv_pool"]["prefix_hit_pages"],
        "prefix_hit_rate": stats["prefix_hit_rate"],
        "pool_bytes": eng.cache_bytes(),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
    }
    return eng, out, counts


def _check_launches(cfg, steps, counts, kernel):
    """The path's kernel (index ``kernel`` of ``counts``) launched once per
    decode step and layer, the other kernel never."""
    want = [0, 0]
    want[kernel] = steps * cfg.num_layers
    if steps == 0 or list(counts) != want:
        raise AssertionError(f"launches (K1, K2) {counts} != {tuple(want)} "
                             f"for {steps} decode steps x {cfg.num_layers} "
                             "layers")


def serve_phase(torch, np, ops, cfg, model, ServeConfig, ExecPolicy,
                PagedEngine):
    reqs = _requests(np, cfg.vocab_size, 16, 1, 256, 64, 512, 32, 64)
    eng, out, counts = _serve(torch, np, ops, cfg, model,
                              serve_config(ServeConfig), [reqs], ExecPolicy,
                              PagedEngine)
    if out["prefix_hit_pages"] < 1:
        raise AssertionError("no prefix hit in the shared-prefix trace")
    _check_launches(cfg, out["decode_steps"], counts, 0)
    eng.close()
    return {**out, "kernel_launches": counts[0]}, counts[0]


# ----------------------------------------------------------------------------
# 6. where a decode step's time goes
# ----------------------------------------------------------------------------

def _trace_steps(torch, eng, steps):
    """Host ms per decode step over ``steps`` untraced steps, then device
    time by kernel over ``steps`` steps under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):                            # warm up
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    rows = []
    for ev in prof.key_averages():
        # Kernels only: an aten op's device time is its kernels', and a
        # user annotation on the device timeline spans kernels counted here.
        if ev.device_type != DeviceType.CUDA or ev.is_user_annotation:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    return {
        "decode_ms_per_step": step_ms,
        "traced_wall_ms_per_step": wall_us / 1e3 / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_busy_share": busy_us / wall_us if wall_us else None,
        "kernel_launches_per_step": sum(r[2] for r in rows) / steps,
        "top_kernels": [{"name": k[:90], "device_ms_per_step": us / 1e3 / steps,
                         "calls_per_step": n / steps}
                        for us, k, n in rows[:8]],
    }


def profile_phase(torch, np, cfg, model, ServeConfig, ExecPolicy,
                  PagedEngine, steps=10, scfg=None, paths=(True, False)):
    """Every slot filled, the kernel path and then the plain gather path
    (``paths``), on the serve phase's configuration unless ``scfg``."""
    scfg = scfg or serve_config(ServeConfig)
    runs = []
    for use_kernel in paths:
        eng = PagedEngine(cfg, model, scfg, ExecPolicy(use_kernel=use_kernel))
        rng = np.random.default_rng(0)
        for _ in range(scfg.max_batch):
            prompt = rng.integers(0, cfg.vocab_size, int(rng.integers(64, 513)))
            eng.submit(prompt, 2 * steps + 8)     # outlives the measurement
        eng.step()                                # admits all 8, one decode
        runs.append({"use_kernel": use_kernel,
                     **_trace_steps(torch, eng, steps)})
        eng.close()
        del eng
        torch.cuda.empty_cache()
    return {"arch": cfg.arch_id, "dtype": cfg.dtype, "slots": scfg.max_batch,
            "kv_quant": scfg.kv_quant, "steps": steps, "runs": runs}


# ----------------------------------------------------------------------------
# 7. kernel path == plain path, greedy, f32
# ----------------------------------------------------------------------------

def _kernel_vs_plain(np, cfg, model, scfg, ExecPolicy, PagedEngine):
    """Greedy tokens of 8 requests with the kernel and with the plain
    path; they must be identical.  Returns the number of tokens."""
    reqs = _requests(np, cfg.vocab_size, 8, 2, 128, 32, 300, 16, 16)
    outs = {}
    for use_kernel in (True, False):
        eng = PagedEngine(cfg, model, scfg, ExecPolicy(use_kernel=use_kernel))
        got = eng.generate([p for p, _ in reqs], 16)
        outs[use_kernel] = [got[i].output for i in range(len(reqs))]
        eng.close()
    if outs[True] != outs[False]:
        diff = [i for i in range(len(reqs)) if outs[True][i] != outs[False][i]]
        raise AssertionError(f"{scfg.kv_quant} pages: kernel and plain "
                             f"greedy tokens differ in requests {diff}")
    return len(reqs), sum(len(o) for o in outs[True])


def exact_phase(torch, np, cfg, Transformer, ServeConfig, ExecPolicy,
                PagedEngine):
    model = Transformer.init(cfg, seed=1)
    n, tokens = _kernel_vs_plain(np, cfg, model, serve_config(ServeConfig),
                                 ExecPolicy, PagedEngine)
    return {"arch": cfg.arch_id, "dtype": cfg.dtype, "layers": cfg.num_layers,
            "requests": n, "tokens_compared": tokens, "identical": True}


# ----------------------------------------------------------------------------
# 8-10. int8 pages and the cold tier
# ----------------------------------------------------------------------------

def _waves(np, vocab, seed, sizes, prefix_len, lo, hi, new_lo, new_hi):
    """Three waves of requests, ``sizes`` each: prompts of ``lo..hi``
    tokens sharing a ``prefix_len``-token prefix, unrelated prompts, then
    the shared prefix again with new bodies; ``new_lo..new_hi`` new
    tokens each."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, prefix_len)
    waves = []
    for n, shared in zip(sizes, (True, False, True)):
        wave = []
        for _ in range(n):
            body = rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))
            if shared:
                body[:prefix_len] = prefix
            wave.append((body.astype(np.int32),
                         int(rng.integers(new_lo, new_hi + 1))))
        waves.append(wave)
    return waves


def int8_config(ServeConfig, num_pages):
    """The serve configuration with int8 pages and a 256-page cold tier;
    ``num_pages`` 0 is full residency."""
    return ServeConfig(max_batch=8, max_seq_len=1024, page_size=16,
                       num_pages=num_pages, prefix_cache=True,
                       cold_pages=256, kv_quant="int8", temperature=0.0,
                       engine_mode="paged")


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def check_cold_tier(eng):
    """Spills and faults above 0, every staging task done, every cold
    entry in host memory."""
    if not eng.executor.drain():
        raise AssertionError("the sidecar did not drain")
    ex = eng.executor.stats()
    if ex["failed"] or ex["dropped"]:
        raise AssertionError(f"sidecar tasks failed or dropped: {ex}")
    pool = eng.pool.stats()
    if pool["spills"] < 1 or pool["faults"] < 1:
        raise AssertionError(f"no spill or no fault-in: {pool}")
    blobs = eng.cold.blobs()
    on_card = sum(t.is_cuda for b in blobs for t in _leaves(b))
    if on_card:
        raise AssertionError(f"{on_card} cold-tier tensors still on the "
                             "card after the sidecar drained")
    return {"spills": pool["spills"], "faults": pool["faults"],
            "cold_entries": len(blobs), "cold_dropped": eng.cold.dropped,
            "sidecar_completed": ex["completed"],
            "sidecar_mean_run_ms": 1e3 * ex["mean_run_s"]}


INT8_SERVE_PAGES = 161     # 160 usable pages of 16 tokens, against 513


def serve_int8_phase(torch, np, ops, cfg, model, ServeConfig, ExecPolicy,
                     PagedEngine):
    scfg = int8_config(ServeConfig, INT8_SERVE_PAGES)
    waves = _waves(np, cfg.vocab_size, 4, (8, 8, 8), 256, 300, 512, 32, 64)
    eng, out, counts = _serve(torch, np, ops, cfg, model, scfg, waves,
                              ExecPolicy, PagedEngine)
    _check_launches(cfg, out["decode_steps"], counts, 1)
    out = {**out, "kv_quant": scfg.kv_quant, "num_pages": scfg.num_pages,
           "cold_capacity": scfg.cold_pages, "kernel_launches": counts[1],
           "bf16_kernel_launches": counts[0], **check_cold_tier(eng)}
    eng.close()
    return out, counts[1]


def exact_int8_phase(torch, np, cfg, Transformer, ServeConfig, ExecPolicy,
                     PagedEngine):
    """(a) K2 == plain path; (b) a tight pool with the cold tier == a
    full-residency pool; greedy tokens, f32, int8 pages."""
    model = Transformer.init(cfg, seed=1)
    n, tokens = _kernel_vs_plain(np, cfg, model, int8_config(ServeConfig, 0),
                                 ExecPolicy, PagedEngine)

    waves = _waves(np, cfg.vocab_size, 5, (4, 6, 4), 128, 150, 300, 16, 16)
    tiers = {}
    cold = None
    for num_pages in (80, 0):
        eng = PagedEngine(cfg, model, int8_config(ServeConfig, num_pages),
                          ExecPolicy(use_kernel=True))
        rids = _run_waves(eng, waves)
        tiers[num_pages] = [eng.request(r).output for r in rids]
        if num_pages:
            cold = check_cold_tier(eng)
        eng.close()
    if tiers[80] != tiers[0]:
        diff = [i for i, (a, b) in enumerate(zip(tiers[80], tiers[0]))
                if a != b]
        raise AssertionError(f"cold-tier and full-residency greedy tokens "
                             f"differ in requests {diff}")
    return {"arch": cfg.arch_id, "dtype": cfg.dtype, "layers": cfg.num_layers,
            "kv_quant": "int8", "requests": n, "tokens_compared": tokens,
            "kernel_equals_plain": True,
            "cold_tier_requests": len(tiers[0]),
            "cold_tier_tokens_compared": sum(len(o) for o in tiers[0]),
            "cold_tier_equals_full_residency": True, "tight_pool_pages": 80,
            **cold}


def _kernel_entry(name, source, replaces, function, launches, check):
    """One kernel's line item: the bf16 numbers at the serving shape, the
    f32 error beside them, ``launches`` from its main path's run."""
    main_dtype = check["checks"]["bfloat16"]
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "replaces_function": function,
        "launches": launches,
        "max_abs_err": main_dtype["max_abs_err"],
        "max_abs_err_by_dtype": {k: v["max_abs_err"]
                                 for k, v in check["checks"].items()},
        "dtype": "bfloat16",
        "ms": main_dtype["ms"],
        "kernel_ms": main_dtype["ms"],
        "plain_ms": main_dtype["plain_ms"],
        "bound_ms": main_dtype["bound_ms"],
        "bound_by": main_dtype["bound_by"],
        "library_ms": main_dtype["library_ms"],
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import numpy as np
        from repro_torch.config import ServeConfig, get_config
        from repro_torch.kernels.paged_attention import kernel, ops, ref
        from repro_torch.models.attention import kv_dequantize, kv_quantize
        from repro_torch.models.transformer import ExecPolicy, Transformer
        from repro_torch.serve import PagedEngine
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {ROOT}: {e}",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device_name": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    built = kernel.build()
    emit({"phase": "build",
          "kernels": {name: str(lib) for name, (lib, _) in built.items()},
          "seconds": time.perf_counter() - t0,
          "ptxas": {name: [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln]
                    for name, (_, log) in built.items()}})

    check = kernel_phase(torch, np, ops, ref)
    emit({"phase": "kernel", **check})
    qcheck = quant_kernel_phase(torch, np, ops, ref, kv_quantize,
                                kv_dequantize)
    emit({"phase": "kernel-int8", **qcheck})

    smollm = get_config("smollm-360m")
    model = Transformer.init(smollm, seed=0)
    serve, launches = serve_phase(torch, np, ops, smollm, model,
                                  ServeConfig, ExecPolicy, PagedEngine)
    emit({"phase": "serve", **serve})
    emit({"phase": "profile", **profile_phase(torch, np, smollm, model,
                                              ServeConfig, ExecPolicy,
                                              PagedEngine)})
    serve8, quant_launches = serve_int8_phase(
        torch, np, ops, smollm, model, ServeConfig, ExecPolicy, PagedEngine)
    emit({"phase": "serve-int8", **serve8})
    emit({"phase": "profile-int8", **profile_phase(
        torch, np, smollm, model, ServeConfig, ExecPolicy, PagedEngine,
        scfg=int8_config(ServeConfig, 0), paths=(True,))})
    del model
    torch.cuda.empty_cache()

    exact_cfg = dataclasses.replace(smollm, num_layers=4, dtype="float32")
    emit({"phase": "exact", **exact_phase(torch, np, exact_cfg, Transformer,
                                          ServeConfig, ExecPolicy,
                                          PagedEngine)})
    emit({"phase": "exact-int8", **exact_int8_phase(
        torch, np, exact_cfg, Transformer, ServeConfig, ExecPolicy,
        PagedEngine)})

    print(card_line(), flush=True)
    emit({"kernels": [
        _kernel_entry(
            "paged_attention", "src/repro_torch/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention/kernel.py:73",
            "src/repro/kernels/paged_attention/kernel.py"
            "::paged_attention_bjgn", launches, check),
        _kernel_entry(
            "paged_attention_quant",
            "src/repro_torch/csrc/paged_attention_quant.cu",
            "src/repro/kernels/paged_attention/kernel.py:168",
            "src/repro/kernels/paged_attention/kernel.py"
            "::paged_attention_quant_bjgn", quant_launches, qcheck),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # any failed phase: report, no final line
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        sys.exit(1)
