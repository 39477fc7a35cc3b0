"""Inference CLI: decode a prompt with a llama-family model on one CUDA
card (or the CPU).

The port of examples/llama/generate_llama.py.  Weights come from a
training checkpoint (--ckpt-dir: runtime/train.Checkpointer, as
train_llama saves it; only the parameters are read) or, with --smoke
alone, from a seed (models/bridge.init_params).  The prompt is tokenized
with the byte tokenizer and decoded over dense ring caches by
llama.generate, or, with --draft-layers / --draft-ckpt-dir, by
speculative.speculative_generate (greedy tokens equal plain decoding).
--int8 serves int8 weights (quantized from the f32 parameters after the
load), --int8-kv int8 rings; --temperature/--top-k/--top-p sample with a
torch.Generator seeded by --seed; --prefill-chunk streams the prompt.

    python -m tf_operator_tpu_torch.generate_llama --smoke --device cpu --prompt hi
    python -m tf_operator_tpu_torch.generate_llama --smoke --prompt hello --max-new 16 --draft-layers 1
    python -m tf_operator_tpu_torch.generate_llama --smoke --ckpt-dir C --prompt hi

`resolve_config`, `load_params` and `build_draft` are shared with the
serving CLI (serve_llama.py), as the JAX package's two scripts share
them.  Hugging Face directories and tokenizers, and the mixtral preset,
are not ported yet; each raises NotImplementedError naming its ROADMAP
item.
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
from tf_operator_tpu_torch.runtime.train import Checkpointer

NO_WEIGHTS = ("no weights: pass --ckpt-dir, --hf-dir, or --smoke "
              "(random tiny weights, testing only)")
_NOT_PORTED = {
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


def check_ported(args) -> None:
    """Raise NotImplementedError for a flag the port does not take yet."""
    for flag, on in (("hf_dir", bool(args.hf_dir)),
                     ("tokenizer", args.tokenizer != "byte"),
                     ("mixtral", args.model == "mixtral")):
        if on:
            raise NotImplementedError(
                f"{flag}: not ported yet ({_NOT_PORTED[flag]})")


def resolve_config(args) -> llama.LlamaConfig:
    """The preset (tied embeddings, as the JAX script builds it), or the
    tiny f32 model of --smoke — shared with serve_llama."""
    if args.smoke:
        return llama.tiny(tie_embeddings=True, dtype=torch.float32,
                          max_len=256)
    presets = {"llama3": llama.llama3_8b, "llama31": llama.llama31_8b,
               "mistral": llama.mistral_7b}
    return presets[args.model](tie_embeddings=True)


def load_params(cfg: llama.LlamaConfig, ckpt_dir: str, dev: torch.device,
                smoke: bool = False, int8: bool = False) -> dict:
    """The model's parameters from a training checkpoint's newest step, or
    random ones from seed 0 (--smoke ONLY: decoding an 8B model from
    fresh random weights is never what a user without a checkpoint flag
    meant), in the serving storage dtypes on `dev`; int8=True quantizes
    the f32 parameters after the load (quant.quantize_params)."""
    if not ckpt_dir and not smoke:
        raise SystemExit(NO_WEIGHTS)
    if ckpt_dir:
        ckpt = Checkpointer(ckpt_dir)
        step = ckpt.latest_step()
        if step is None:
            raise SystemExit(f"no checkpoint under {ckpt_dir}")
        # the names and storage dtypes the serving model holds; int8
        # quantizes the trainer's f32 masters as they were saved
        with torch.device("meta"):
            want = llama.Llama(cfg, train=int8).state_dict()
        params = ckpt.restore_params(want, device=dev)
        print(f"restored step {step} from {ckpt_dir}")
    else:
        params = bridge.init_params(cfg, 0, device=dev, train=int8)
    return quant.quantize_params(params) if int8 else params


def build_model(cfg: llama.LlamaConfig, ckpt_dir: str, dev: torch.device,
                smoke: bool = False, int8: bool = False) -> llama.Llama:
    """A serving Llama around load_params' weights."""
    return llama.Llama.from_params(
        cfg, load_params(cfg, ckpt_dir, dev, smoke=smoke, int8=int8),
        device=dev)


def build_draft(args, cfg: llama.LlamaConfig,
                dev: torch.device) -> llama.Llama:
    """The draft model from --draft-ckpt-dir / --draft-layers (default a
    quarter of the target's layers), quantized when --int8 — shared with
    serve_llama.  From a seed, the draft's weights are the target's first
    layers (the same draws)."""
    d_layers = args.draft_layers or max(1, cfg.n_layers // 4)
    d_cfg = dataclasses.replace(cfg, n_layers=d_layers)
    return build_model(d_cfg, args.draft_ckpt_dir, dev, smoke=args.smoke,
                       int8=args.int8)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompt", required=True)
    ap.add_argument("--max-new", type=int, default=64)
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
    ap.add_argument("--int8", action="store_true",
                    help="weight-only int8 quantized decode")
    ap.add_argument("--int8-kv", action="store_true",
                    help="int8 KV rings")
    ap.add_argument("--draft-ckpt-dir", default="",
                    help="draft checkpoint -> speculative decoding")
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

    check_ported(args)
    dev = resolve_device(args.device)
    cfg = resolve_config(args)
    model = build_model(cfg, args.ckpt_dir, dev, smoke=args.smoke,
                        int8=args.int8)
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
    if args.draft_ckpt_dir or args.draft_layers:
        draft = build_draft(args, cfg, dev)
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
