"""Inference CLI: decode a prompt with a llama-family model on one CUDA
card (or the CPU).

The port of examples/llama/generate_llama.py.  Weights come from a
training checkpoint (--ckpt-dir: runtime/train.Checkpointer, as
train_llama saves it; only the parameters are read), from a local
Hugging Face LlamaForCausalLM or MixtralForCausalLM directory (--hf-dir:
its config through models/convert.config_from_hf, its weights through
import_hf_llama) or, with --smoke alone, from a seed
(models/bridge.init_params).  The prompt is tokenized with the byte
tokenizer or a local tokenizer directory (--tokenizer,
data/tokenize.load_tokenizer) and decoded over dense ring caches by
llama.generate, or, with --draft-layers / --draft-ckpt-dir, by
speculative.speculative_generate (greedy tokens equal plain decoding).
--int8 serves int8 weights (quantized from the f32 parameters after the
load), --int8-kv int8 rings; --temperature/--top-k/--top-p sample with a
torch.Generator seeded by --seed; --prefill-chunk streams the prompt.

    python -m tf_operator_tpu_torch.generate_llama --smoke --device cpu --prompt hi
    python -m tf_operator_tpu_torch.generate_llama --smoke --prompt hello --max-new 16 --draft-layers 1
    python -m tf_operator_tpu_torch.generate_llama --smoke --ckpt-dir C --prompt hi
    python -m tf_operator_tpu_torch.generate_llama --device cpu --hf-dir D --tokenizer D --prompt hi

`resolve_config`, `load_params` and `build_draft` are shared with the
serving CLI (serve_llama.py), as the JAX package's two scripts share
them.  One difference: --smoke --model mixtral is the tiny model with
train_llama's smoke experts (4, top-2, in every block), so that a
checkpoint of `train_llama --smoke --model mixtral` serves; the JAX
script's --smoke ignores --model.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from tf_operator_tpu_torch.data.tokenize import (  # noqa: F401
    ByteTokenizer, load_tokenizer)
from tf_operator_tpu_torch.device import resolve_device
from tf_operator_tpu_torch.models import bridge, convert, llama, quant
from tf_operator_tpu_torch.models.speculative import speculative_generate
from tf_operator_tpu_torch.runtime.train import Checkpointer
from tf_operator_tpu_torch.train_llama import SMOKE_MOE

NO_WEIGHTS = ("no weights: pass --ckpt-dir, --hf-dir, or --smoke "
              "(random tiny weights, testing only)")


def resolve_config(args) -> llama.LlamaConfig:
    """The preset (tied embeddings, as the JAX script builds it), the
    tiny f32 model of --smoke (with train_llama's smoke experts for
    --model mixtral), or the config of a local Hugging Face directory
    (--hf-dir, which overrides both) — shared with serve_llama."""
    presets = {"llama3": llama.llama3_8b, "llama31": llama.llama31_8b,
               "mistral": llama.mistral_7b, "mixtral": llama.mixtral_8x7b}
    if args.smoke:
        moe = SMOKE_MOE if args.model == "mixtral" else {}
        cfg = llama.tiny(tie_embeddings=True, dtype=torch.float32,
                         max_len=256, **moe)
    else:
        cfg = presets[args.model](tie_embeddings=True)
    if args.hf_dir:
        import transformers

        cfg = convert.config_from_hf(transformers.AutoConfig.from_pretrained(
            args.hf_dir, local_files_only=True))
    return cfg


def load_params(cfg: llama.LlamaConfig, ckpt_dir: str, dev: torch.device,
                smoke: bool = False, int8: bool = False,
                hf_dir: str = "") -> dict:
    """The model's parameters from a local Hugging Face directory, a
    training checkpoint's newest step, or random ones from seed 0
    (--smoke ONLY: decoding an 8B model from fresh random weights is
    never what a user without a checkpoint flag meant), in the serving
    storage dtypes on `dev`; int8=True quantizes the f32 parameters after
    the load (quant.quantize_params)."""
    if hf_dir:
        import transformers

        hf = transformers.AutoModelForCausalLM.from_pretrained(
            hf_dir, local_files_only=True)
        params = {k: v.to(dev) for k, v in convert.params_from_hf(
            hf.state_dict(), cfg, train=int8).items()}
        del hf
        print(f"imported {cfg.n_layers} layers from {hf_dir}")
        return quant.quantize_params(params) if int8 else params
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
                smoke: bool = False, int8: bool = False,
                hf_dir: str = "") -> llama.Llama:
    """A serving Llama around load_params' weights."""
    return llama.Llama.from_params(
        cfg, load_params(cfg, ckpt_dir, dev, smoke=smoke, int8=int8,
                         hf_dir=hf_dir),
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
    ap.add_argument("--hf-dir", default="",
                    help="LOCAL Hugging Face checkpoint directory")
    ap.add_argument("--tokenizer", default="byte",
                    help="'byte' or a local HF tokenizer directory")
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

    dev = resolve_device(args.device)
    cfg = resolve_config(args)
    model = build_model(cfg, args.ckpt_dir, dev, smoke=args.smoke,
                        int8=args.int8, hf_dir=args.hf_dir)
    xform = quant.make_dequantizer(cfg.dtype) if args.int8 else None
    if args.int8:
        print("weights: int8 + per-channel scales")
    if args.int8_kv:
        print("kv cache: int8 + per-head scales")

    tok = load_tokenizer(args.tokenizer)
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
