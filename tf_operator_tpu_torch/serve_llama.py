"""Serving CLI: batched serving of a request list on one CUDA card (or
the CPU).

The port of examples/llama/serve_llama.py.  Feeds a batch of prompts
through models/serving.serve_loop: a fixed set of decode lanes with slot
admission (a finished request frees its lane and the next queued prompt
prefills into it while every other lane keeps decoding).  Every serving
feature composes here:

  --slots N          decode lanes
  --int8 / --int8-kv weight-only int8 decode / int8 KV caches
  --draft-layers K   speculative serving (or --draft-ckpt-dir): per-lane
                     draft+verify rounds, spec_k tokens a round
  --temperature/--top-k/--top-p   sampling (a torch.Generator seeded by
                     --seed)
  --system-prompt    a shared prefix, prefilled once
  --prefill-chunk    long prompts stream into each lane's cache in
                     segments (--prefill-chunks-per-sync bounds them)
  --steps-per-sync   decode-block size between host syncs
  --paged            a paged KV pool (--block-size, --pool-blocks), read
                     by the CUDA kernels K1/K1q on the card and their
                     plain versions on the CPU; without it dense per-lane
                     rings, as the JAX script serves by default (the
                     port's serve_loop itself defaults to paged)

Prompts come one per line from --prompts-file, or from repeated --prompt
flags.  Outputs print in request order with their schedule (slot,
admitted/finished step) and the aggregate tokens/sec, in the JAX
script's words.  Weights (--ckpt-dir, --smoke) and the draft come from
generate_llama's shared loaders.

    python -m tf_operator_tpu_torch.serve_llama --smoke --device cpu --prompt hello --prompt "the quick brown fox" --max-new 16
    python -m tf_operator_tpu_torch.serve_llama --smoke --ckpt-dir C --paged --int8-kv --prompt hi
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from tf_operator_tpu_torch.device import resolve_device
from tf_operator_tpu_torch.generate_llama import (
    ByteTokenizer, build_draft, build_model, check_ported, resolve_config)
from tf_operator_tpu_torch.models import quant
from tf_operator_tpu_torch.models.serving import serve_loop

# the JAX script's --paged-kernel choices that name TPU-side read paths
_TPU_READ_PATHS = {
    "pallas": "the block-indexed Pallas decode kernel",
    "gather": "the table-gathered linear view",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompt", action="append", default=[],
                    help="repeatable; one request per flag")
    ap.add_argument("--prompts-file", default="",
                    help="one prompt per line")
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--steps-per-sync", type=int, default=8)
    ap.add_argument("--model", default="llama3",
                    choices=["llama3", "llama31", "mistral", "mixtral"])
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory from train_llama")
    ap.add_argument("--hf-dir", default="")
    ap.add_argument("--tokenizer", default="byte")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the sampling generator")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--int8-kv", action="store_true")
    ap.add_argument("--draft-ckpt-dir", default="",
                    help="draft checkpoint -> speculative serving")
    ap.add_argument("--draft-layers", type=int, default=0,
                    help="smoke: random draft with this many layers")
    ap.add_argument("--spec-k", type=int, default=4)
    ap.add_argument("--system-prompt", default="",
                    help="shared prefix prepended to every request but "
                         "prefilled ONCE; with --prefill-chunk its token "
                         "length must be a chunk multiple")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: block-pool attention with "
                         "memory-gated admission and copy-free prefix "
                         "sharing")
    ap.add_argument("--block-size", type=int, default=64,
                    help="KV block size in tokens (with --paged)")
    ap.add_argument("--pool-blocks", type=int, default=0,
                    help="block-pool capacity; 0 = every lane can hold "
                         "the worst case")
    ap.add_argument("--paged-kernel", default="auto",
                    choices=["auto", *_TPU_READ_PATHS],
                    help="paged read path: 'auto' = the CUDA kernels "
                         "(K1/K1q) on the card, their plain versions on "
                         "the CPU; 'pallas' and 'gather' are the JAX "
                         "package's TPU-side paths and are refused")
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--prefill-chunks-per-sync", type=int, default=0,
                    help="stream at most this many prompt segments per "
                         "decode block")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny random model, CPU ok")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.paged_kernel != "auto":
        raise SystemExit(
            f"--paged-kernel {args.paged_kernel}: "
            f"{_TPU_READ_PATHS[args.paged_kernel]} is a TPU-side read path "
            f"of the JAX package, which the port does not have; the port "
            f"reads paged pools through K1/K1q on the card and their plain "
            f"versions on the CPU (--paged-kernel auto)")
    prompts = list(args.prompt)
    if args.prompts_file:
        with open(args.prompts_file) as f:
            prompts += [line.rstrip("\n") for line in f if line.strip()]
    if not prompts:
        raise SystemExit("no requests: pass --prompt or --prompts-file")
    check_ported(args)
    dev = resolve_device(args.device)
    cfg = resolve_config(args)
    model = build_model(cfg, args.ckpt_dir, dev, smoke=args.smoke,
                        int8=args.int8)

    tok = ByteTokenizer()
    requests = []
    for i, p in enumerate(prompts):
        ids = tok.encode(p)
        if not ids:
            raise SystemExit(
                f"request {i} ({p!r}): empty prompt after tokenization")
        requests.append(ids)

    # top_k/top_p forward verbatim (the library's own validation message
    # beats a silent mask here)
    kw = {"top_k": args.top_k, "top_p": args.top_p}
    if args.int8:
        kw["params_transform"] = quant.make_dequantizer(cfg.dtype)
        print("weights: int8 + per-channel scales")
    if args.int8_kv:
        kw["kv_quant"] = True
        print("kv caches: int8 + per-head scales")
    if args.prefill_chunk:
        kw["prefill_chunk"] = args.prefill_chunk
    if args.prefill_chunks_per_sync:
        kw["prefill_chunks_per_sync"] = args.prefill_chunks_per_sync
    if args.system_prompt:
        pfx = tok.encode(args.system_prompt)
        kw["shared_prefix"] = pfx
        print(f"system prompt: {len(pfx)} tokens, prefilled once")
    if args.temperature > 0.0:
        kw.update(temperature=args.temperature,
                  generator=torch.Generator(device=dev).manual_seed(
                      args.seed))

    if args.draft_ckpt_dir or args.draft_layers:
        draft = build_draft(args, cfg, dev)
        if args.int8:
            kw["draft_transform"] = quant.make_dequantizer(cfg.dtype)
        kw.update(draft=draft, spec_k=args.spec_k)
        print(f"speculative serving: {draft.cfg.n_layers}-layer "
              f"draft, k={args.spec_k}")

    kw["paged"] = args.paged
    if args.paged:
        kw["block_size"] = args.block_size
        if args.pool_blocks:
            kw["pool_blocks"] = args.pool_blocks
        print(f"paged KV cache: block_size={args.block_size}, "
              f"pool_blocks={args.pool_blocks or 'auto'}, "
              f"kernel={args.paged_kernel}")

    t0 = time.perf_counter()
    results = serve_loop(model, requests, slots=args.slots,
                         max_new_tokens=args.max_new, eos_id=tok.eos_id,
                         steps_per_sync=args.steps_per_sync, device=dev,
                         **kw)
    dt = time.perf_counter() - t0
    n_tokens = sum(len(r.tokens) for r in results)
    for i, (p, r) in enumerate(zip(prompts, results)):
        spec_note = (
            f", acceptance {r.accepted_drafts}/{r.proposed_drafts}"
            if r.proposed_drafts else "")
        print(f"--- request {i} (slot {r.slot}, steps "
              f"{r.admitted_at_step}->{r.finished_at_step}{spec_note})")
        print(f"    {p!r} -> {tok.decode(r.tokens)!r}")
    print(f"{len(requests)} requests, {n_tokens} tokens through "
          f"{args.slots} lanes in {dt:.2f}s "
          f"({n_tokens / dt:.1f} tok/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
