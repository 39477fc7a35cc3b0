"""Hugging Face checkpoints in the port (tf_operator_tpu_torch.models
.convert, data/tokenize and the CLIs' --hf-dir / --tokenizer) on the
CPU: a randomly initialized MixtralForCausalLM and LlamaForCausalLM give
the port's logits; the port's import is the JAX package's numpy tree;
export inverts import, through the port's state dict; the refusals carry
JAX's words; generate_llama and serve_llama serve a save_pretrained
directory, and read a tokenizer directory built here with `tokenizers`.
Nothing is downloaded."""
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import convert as jconvert
from tf_operator_tpu_torch import generate_llama, serve_llama
from tf_operator_tpu_torch.data import tokenize as ttok
from tf_operator_tpu_torch.models import bridge, convert, llama as tl

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

SHAPE = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=64,
             rms_norm_eps=1e-5, rope_theta=10000.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: one torch thread (the count is put back after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hf_models():
    """{"mixtral": ..., "llama": ...}: random HF models (seeded) and
    their configs through the port's config_from_hf at f32.  The model
    classes are imported with transformers' TensorFlow and scikit-learn
    integrations reported absent (neither is used here; importing them
    costs about 15 s), and the flags are put back after."""
    from transformers.utils import import_utils

    saved = import_utils._tf_available, import_utils._sklearn_available
    import_utils._tf_available = import_utils._sklearn_available = False
    try:
        transformers.MixtralForCausalLM, transformers.LlamaForCausalLM
    finally:
        import_utils._tf_available, import_utils._sklearn_available = saved
    out = {}
    torch.manual_seed(5)
    mcfg = transformers.MixtralConfig(
        num_local_experts=4, num_experts_per_tok=2, tie_word_embeddings=False,
        sliding_window=None, attention_dropout=0.0, **SHAPE)
    out["mixtral"] = transformers.MixtralForCausalLM(mcfg).eval()
    torch.manual_seed(0)
    lcfg = transformers.LlamaConfig(attention_bias=False, mlp_bias=False,
                                    tie_word_embeddings=False, **SHAPE)
    out["llama"] = transformers.LlamaForCausalLM(lcfg).eval()
    return {k: (m, convert.config_from_hf(m.config, dtype=torch.float32))
            for k, m in out.items()}


@pytest.mark.parametrize("kind", ["mixtral", "llama"])
def test_logits_match_transformers(hf_models, kind):
    hf, cfg = hf_models[kind]
    assert (cfg.n_experts, cfg.moe_top_k) == ((4, 2) if kind == "mixtral"
                                              else (0, 1))
    model = tl.Llama.from_params(cfg, convert.params_from_hf(
        hf.state_dict(), cfg), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, 256,
                                                                (2, 16)))
    with torch.no_grad():
        want = hf(tokens).logits
        got = model(tokens)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("kind", ["mixtral", "llama"])
def test_import_and_export_equal_jax(hf_models, kind):
    """The port's config is JAX's, its imported tree is JAX's array for
    array, and export inverts import through the port's state dict
    (params_from_hf, then bridge.params_to_tree), equal to JAX's
    export."""
    hf, cfg = hf_models[kind]
    sd = hf.state_dict()
    jcfg = jconvert.config_from_hf(hf.config)
    for key, val in vars(cfg).items():
        if key != "dtype":
            assert val == getattr(jcfg, key), key
    mine, theirs = convert.import_hf_llama(sd, cfg), \
        jconvert.import_hf_llama(sd, jcfg)
    flat = lambda tree, p="": ({f"{p}{k}": v for k, v in tree.items()}
                               if not any(isinstance(v, dict)
                                          for v in tree.values()) else
                               {kk: vv for k, v in tree.items()
                                for kk, vv in (flat(v, f"{p}{k}/").items()
                                               if isinstance(v, dict)
                                               else [(f"{p}{k}", v)])})
    a, b = flat(mine), flat(theirs)
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    tree = bridge.params_to_tree(cfg, convert.params_from_hf(sd, cfg,
                                                            train=True))
    out = convert.export_hf_llama(tree, cfg)
    jout = jconvert.export_hf_llama(theirs, jcfg)
    assert set(out) == set(sd) == set(jout)
    for k, v in sd.items():
        assert np.array_equal(out[k], v.numpy()), k
        assert np.array_equal(out[k], jout[k]), k


def _refusal(fn_mine, fn_theirs, exc):
    with pytest.raises(exc) as theirs:
        fn_theirs()
    with pytest.raises(exc) as mine:
        fn_mine()
    assert str(mine.value) == str(theirs.value)


def test_refusals_carry_jax_words(hf_models):
    hf, cfg = hf_models["llama"]
    d = hf.config.to_dict()
    for bad, exc in ((dict(d, rope_scaling={"rope_type": "linear",
                                            "factor": 2.0}), ValueError),
                     (dict(d, hidden_act="gelu"), ValueError)):
        _refusal(lambda: convert.config_from_hf(bad),
                 lambda: jconvert.config_from_hf(bad), exc)
    jcfg = jconvert.config_from_hf(d)
    sd = hf.state_dict()
    wrong = dict(d, intermediate_size=96)
    cases = [
        ({k: v for k, v in sd.items() if k != "model.norm.weight"}, d,
         KeyError),
        (sd, wrong, ValueError),
        (dict(sd, **{"model.layers.0.self_attn.q_proj.bias": torch.zeros(64)}),
         d, ValueError),
        (sd, dict(d, tie_word_embeddings=True), ValueError),
    ]
    for state, conf, exc in cases:
        _refusal(lambda: convert.import_hf_llama(
                     state, convert.config_from_hf(conf)),
                 lambda: jconvert.import_hf_llama(
                     state, jconvert.config_from_hf(conf)), exc)
    mixed = tl.tiny(n_experts=4, moe_every=2)
    jmixed = jconvert.config_from_hf(dict(d, num_local_experts=4),
                                     moe_every=2)
    _refusal(lambda: convert.export_hf_llama({}, mixed),
             lambda: jconvert.export_hf_llama({}, jmixed), ValueError)
    assert jcfg.n_experts == 0


def _tokens(out: str):
    line = [l for l in out.splitlines() if l.startswith("tokens: ")][-1]
    return [int(t) for t in line[len("tokens: ["):-1].split(", ")]


def test_hf_dir_serves_a_saved_mixtral(hf_models, tmp_path, capsys):
    """--hf-dir: the config (bf16, as JAX's config_from_hf gives it) and
    the weights of a save_pretrained directory; generate_llama's greedy
    tokens are llama.generate's over the imported model, and serve_llama
    serves the same directory with int8 weights, paged."""
    hf, _ = hf_models["mixtral"]
    hf.save_pretrained(tmp_path)
    assert generate_llama.main(["--device", "cpu", "--hf-dir", str(tmp_path),
                                "--prompt", "hi", "--max-new", "6"]) == 0
    got = _tokens(capsys.readouterr().out)
    cfg = convert.config_from_hf(hf.config)
    assert cfg.dtype == torch.bfloat16
    model = tl.Llama.from_params(cfg, convert.params_from_hf(
        hf.state_dict(), cfg), device="cpu")
    prompt = torch.tensor([ttok.ByteTokenizer().encode("hi")])
    want = tl.generate(model, prompt, 6, eos_id=0, device="cpu")
    assert got == want[0].tolist()
    assert serve_llama.main(["--device", "cpu", "--hf-dir", str(tmp_path),
                             "--int8", "--paged", "--block-size", "4",
                             "--max-new", "4", "--prompt", "hi",
                             "--prompt", "the fox"]) == 0
    out = capsys.readouterr().out
    assert "weights: int8" in out and "2 requests" in out


def test_tokenizer_directory(tmp_path, capsys):
    """--tokenizer DIR: a word-level tokenizer built locally, saved as a
    PreTrainedTokenizerFast directory; the port's load_tokenizer encodes
    as the JAX package's, and generate_llama decodes with it."""
    from tf_operator_tpu.data import tokenize as jtok

    words = ["[UNK]", "</s>", "hello", "world", "the", "fox"]
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(
        {w: i for i, w in enumerate(words)}, unk_token="[UNK]"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, eos_token="</s>",
        unk_token="[UNK]").save_pretrained(tmp_path)
    mine, theirs = ttok.load_tokenizer(str(tmp_path)), \
        jtok.load_tokenizer(str(tmp_path))
    assert mine.encode("hello the fox") == theirs.encode("hello the fox") \
        == [2, 4, 5]
    assert (mine.vocab_size, mine.eos_id) == (theirs.vocab_size, 1)
    assert mine.decode([3, 2]) == theirs.decode([3, 2])
    assert generate_llama.main(["--smoke", "--device", "cpu", "--tokenizer",
                                str(tmp_path), "--prompt", "hello world",
                                "--max-new", "4"]) == 0
    assert len(_tokens(capsys.readouterr().out)) == 4
