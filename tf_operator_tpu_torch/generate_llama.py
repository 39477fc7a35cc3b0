"""Inference CLI: decode a prompt with a llama-family model on one CUDA
card (or the CPU).

The port of examples/llama/generate_llama.py.  The prompt is tokenized
with the byte tokenizer and decoded over dense ring caches by
llama.generate, or, with --draft-layers, by speculative.speculative_generate
with a draft of the model's first layers (greedy tokens equal plain
decoding).  --int8 serves int8 weights (quantized from the f32 draws),
--int8-kv int8 rings; --temperature/--top-k/--top-p sample with a
torch.Generator seeded by --seed; --prefill-chunk streams the prompt.

    python -m tf_operator_tpu_torch.generate_llama --smoke --device cpu --prompt hi
    python -m tf_operator_tpu_torch.generate_llama --smoke --prompt hello --max-new 16 --draft-layers 1

Weights come from a seed (models/bridge.init_params), so only --smoke
runs: without it the call is refused for want of weights, as the JAX
script refuses it without a checkpoint.  Checkpoints, Hugging Face
directories and tokenizers, and the mixtral preset are not ported yet;
each raises NotImplementedError naming its ROADMAP item.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Iterable, List

import torch

from tf_operator_tpu_torch.device import resolve_device
from tf_operator_tpu_torch.models import bridge, llama, quant
from tf_operator_tpu_torch.models.speculative import speculative_generate

_NOT_PORTED = {
    "ckpt_dir": "ROADMAP Queue 1 item 9 (Checkpointer)",
    "draft_ckpt_dir": "ROADMAP Queue 1 item 9 (Checkpointer)",
    "hf_dir": "ROADMAP Queue 1 item 10 (Hugging Face checkpoints)",
    "tokenizer": "ROADMAP Queue 1 item 10 (Hugging Face tokenizers)",
    "mixtral": "ROADMAP Queue 1 item 10 (mixtral preset)",
}


class ByteTokenizer:
    """Reversible byte-level tokenizer: token i is byte i.  NUL (0)
    doubles as EOS: it never occurs in text, so the vocabulary stays
    exactly 256 (a copy of the JAX package's data.tokenize.ByteTokenizer)."""

    vocab_size = 256
    eos_id = 0

    def encode(self, text: str) -> List[int]:
        return [b or 32 for b in text.encode("utf-8")]  # NUL -> space

    def decode(self, ids: Iterable[int]) -> str:
        return bytes(i for i in ids if i > 0).decode("utf-8", "replace")


def resolve_config(args) -> llama.LlamaConfig:
    """The preset (tied embeddings, as the JAX script builds it), or the
    tiny f32 model of --smoke."""
    if args.smoke:
        return llama.tiny(tie_embeddings=True, dtype=torch.float32,
                          max_len=256)
    presets = {"llama3": llama.llama3_8b, "llama31": llama.llama31_8b,
               "mistral": llama.mistral_7b}
    return presets[args.model](tie_embeddings=True)


def build_model(cfg: llama.LlamaConfig, int8: bool,
                dev: torch.device) -> llama.Llama:
    """Random weights from seed 0 (the JAX script's PRNGKey(0)); --int8
    quantizes their f32 draws, as the JAX script quantizes its f32
    tree."""
    if int8:
        master = bridge.init_params(cfg, 0, device=dev, train=True)
        return llama.Llama.from_params(cfg, quant.quantize_params(master),
                                       device=dev)
    return llama.Llama.from_params(cfg, bridge.init_params(cfg, 0,
                                                           device=dev),
                                   device=dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompt", required=True)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--model", default="llama3",
                    choices=["llama3", "llama31", "mistral", "mixtral"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--hf-dir", default="")
    ap.add_argument("--tokenizer", default="byte")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the sampling generator")
    ap.add_argument("--int8", action="store_true",
                    help="weight-only int8 quantized decode")
    ap.add_argument("--int8-kv", action="store_true",
                    help="int8 KV rings")
    ap.add_argument("--draft-ckpt-dir", default="")
    ap.add_argument("--draft-layers", type=int, default=0,
                    help="speculative decoding with a draft of this many "
                         "layers")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens per speculation round")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prefill the prompt in segments of this size")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny random model, CPU ok")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    for flag, on in (("ckpt_dir", bool(args.ckpt_dir)),
                     ("draft_ckpt_dir", bool(args.draft_ckpt_dir)),
                     ("hf_dir", bool(args.hf_dir)),
                     ("tokenizer", args.tokenizer != "byte"),
                     ("mixtral", args.model == "mixtral")):
        if on:
            raise NotImplementedError(
                f"{flag}: not ported yet ({_NOT_PORTED[flag]})")
    if not args.smoke:
        raise SystemExit(
            "no weights: pass --ckpt-dir, --hf-dir, or --smoke "
            "(random tiny weights, testing only)")
    dev = resolve_device(args.device)
    cfg = resolve_config(args)
    model = build_model(cfg, args.int8, dev)
    xform = quant.make_dequantizer(cfg.dtype) if args.int8 else None
    if args.int8:
        print("weights: int8 + per-channel scales")
    if args.int8_kv:
        print("kv cache: int8 + per-head scales")

    tok = ByteTokenizer()
    ids = tok.encode(args.prompt)
    if not ids:
        raise SystemExit("empty prompt after tokenization")
    prompt = torch.tensor([ids], dtype=torch.long, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    kw = dict(temperature=args.temperature, top_k=args.top_k,
              top_p=args.top_p, eos_id=tok.eos_id, generator=gen,
              kv_quant=args.int8_kv, device=dev,
              prefill_chunk=args.prefill_chunk or None)
    if args.draft_layers:
        d_cfg = dataclasses.replace(cfg, n_layers=args.draft_layers)
        draft = build_model(d_cfg, args.int8, dev)
        out, stats = speculative_generate(
            model, draft, prompt, args.max_new, k=args.spec_k,
            target_transform=xform, draft_transform=xform,
            return_stats=True, **kw)
        print(f"speculative: {stats['target_forwards']} target forwards "
              f"for {args.max_new} tokens (plain decode = {args.max_new})")
    else:
        out = llama.generate(model, prompt, args.max_new,
                             params_transform=xform, **kw)

    ids_out = [int(t) for t in out[0]]
    print(tok.decode(ids_out))
    print(f"tokens: {ids_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
