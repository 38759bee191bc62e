"""Serving CLI for the port: a mixed-length request stream through the
continuous or paged engine, on the card by default.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --engine-mode paged --requests 16

Weights are random, drawn from ``--seed``.  ``--device cpu`` runs on the
CPU (with the kernels' plain versions); without it the run needs a GPU.
``--kv-quant int8`` stores the paged engine's KV pages as int8 with f32
scales; the paged engine spills evicted prefix pages to the host-memory
cold tier (``ServeConfig.cold_pages``) as the reference does.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.config import EngineMode, ServeConfig, get_config
from repro_torch.models.transformer import ExecPolicy, Transformer
from repro_torch.serve import QueueFull, make_engine


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-seq-len", type=int, default=1024)
    ap.add_argument("--mean-prompt-len", type=int, default=64)
    ap.add_argument("--mean-new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine-mode", default=EngineMode.PAGED.value,
                    choices=[EngineMode.CONTINUOUS.value,
                             EngineMode.PAGED.value])
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=0,
                    help="KV pool pages (0 -> full residency per slot)")
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--kv-quant", default="none", choices=["none", "int8"],
                    help="KV page storage (int8: per-entry/head scales)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    model = Transformer.init(cfg, seed=args.seed, device=args.device)
    scfg = ServeConfig(max_batch=args.max_batch, max_seq_len=args.max_seq_len,
                       temperature=args.temperature, seed=args.seed,
                       page_size=args.page_size, num_pages=args.num_pages,
                       prefix_cache=not args.no_prefix_cache,
                       kv_quant=args.kv_quant, engine_mode=args.engine_mode)
    eng = make_engine(cfg, model, scfg, ExecPolicy())

    rng = np.random.default_rng(args.seed)
    cap = args.max_seq_len // 2
    lens = np.clip(rng.poisson(args.mean_prompt_len, args.requests), 1, cap)
    news = np.clip(rng.poisson(args.mean_new_tokens, args.requests), 1,
                   args.max_seq_len - cap)
    t0 = time.time()
    rids = []
    for L, n in zip(lens, news):
        prompt = rng.integers(0, cfg.vocab_size, int(L)).astype(np.int32)
        while True:
            try:
                rids.append(eng.submit(prompt, int(n)))
                break
            except QueueFull:
                eng.step()
    eng.run()
    eng.executor.drain()
    dt = time.time() - t0

    results = [eng.result(r) for r in rids]
    total_new = sum(len(r["tokens"]) for r in results)
    ttfts = [r["ttft_s"] for r in results]
    print(f"arch={cfg.arch_id} device={eng.device} mode={args.engine_mode} "
          f"requests={args.requests} slots={args.max_batch}")
    print(f"wall={dt:.2f}s  throughput={total_new / dt:.1f} tok/s  "
          f"mean_ttft={1e3 * np.mean(ttfts):.0f}ms  stats={eng.stats()}")
    for rid, out in zip(rids[:4], results[:4]):
        print(f"  req{rid}: prompt={out['prompt_len']} "
              f"tokens={out['tokens'][:10]}"
              f"{'...' if len(out['tokens']) > 10 else ''}")
    eng.close()


if __name__ == "__main__":
    main()
