"""The port's tokenizer.json interpreter against HuggingFace `tokenizers`.

JAX's `HFTokenizer` (which wraps `tokenizers`) is the reference; the
port's `HFTokenizer` runs `llm/tokenizer_json.py` on the standard
library.  The tokenizer.json files are trained here with `tokenizers`
for each pipeline the port serves: GPT-2 byte-level BPE, Llama-3's Split
regex with `ignore_merges`, Qwen's NFC + Split, Llama-2's Prepend /
Replace normalizers with byte fallback, Mistral's Metaspace, Gemma's
Replace + Split.  Encode ids, decode text and `DecodeStream` output must
be equal, exactly, on a fixed corpus and on arbitrary Unicode text.
"""

from __future__ import annotations

import functools
import json
import os

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

tokenizers = pytest.importorskip("tokenizers")

from dynamo_tpu.llm.tokenizer import DecodeStream as JaxDecodeStream  # noqa: E402
from dynamo_tpu.llm.tokenizer import HFTokenizer as JaxHFTokenizer  # noqa: E402
from dynamo_tpu_torch.llm import tokenizer_json as tj  # noqa: E402
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard  # noqa: E402
from dynamo_tpu_torch.llm.tokenizer import DecodeStream, HFTokenizer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                  r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+"
                  r"|\s+(?!\S)|\s+")
QWEN_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                r"|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
LLAMA3_SPECIALS = ["<|begin_of_text|>", "<|end_of_text|>",
                   "<|start_header_id|>", "<|end_header_id|>", "<|eot_id|>"]

CORPUS_EXTRA = [
    "Hello world! It's a test: don't, we'll, they've, I'm, you'd.",
    "Numbers 1234567 and 3.14159, dates 2026-10-18, ½ ² ③ ٣.",
    "Unicode: naïve café, Straße, ÆØÅ, Ελληνικά, русский, 日本語のテキスト,"
    " 한국어, עברית, العربية, हिन्दी, emoji 😀🎉👍🏽 and ZWJ 👨‍👩‍👧.",
    "Tabs\tand\nnewlines\r\n  spaces   and nbsp em space.",
    "def f(x):\n    return x ** 2  # code\n\n\nclass A: pass",
]


def corpus() -> list:
    with open(os.path.join(ROOT, "README.md"), encoding="utf-8") as f:
        text = f.read()[:60000]
    return text.split("\n\n") + CORPUS_EXTRA * 20


def _train(tok, trainer):
    tok.train_from_iterator(corpus(), trainer=trainer)
    return json.loads(tok.to_str())


def _byte_level(pre, specials=(), ignore_merges=False, normalizer=None):
    from tokenizers import Tokenizer, decoders, models, trainers

    tok = Tokenizer(models.BPE(ignore_merges=ignore_merges))
    tok.pre_tokenizer = pre
    tok.decoder = decoders.ByteLevel()
    if normalizer is not None:
        tok.normalizer = normalizer
    from tokenizers import pre_tokenizers

    trainer = trainers.BpeTrainer(
        vocab_size=1200, special_tokens=list(specials),
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        show_progress=False)
    return _train(tok, trainer)


def _sentencepiece(normalizer, pre, decoder, unk="<unk>"):
    from tokenizers import Tokenizer, models, trainers

    tok = Tokenizer(models.BPE(unk_token=unk, fuse_unk=True,
                               byte_fallback=True))
    if normalizer is not None:
        tok.normalizer = normalizer
    if pre is not None:
        tok.pre_tokenizer = pre
    tok.decoder = decoder
    trainer = trainers.BpeTrainer(
        vocab_size=900, special_tokens=[unk, "<s>", "</s>"],
        limit_alphabet=120, show_progress=False)
    spec = _train(tok, trainer)
    # The byte-fallback tokens belong to the model's vocabulary.
    vocab = spec["model"]["vocab"]
    nxt = max(vocab.values()) + 1
    for b in range(256):
        name = f"<0x{b:02X}>"
        if name not in vocab:
            vocab[name] = nxt
            nxt += 1
    return spec


@functools.lru_cache(maxsize=None)
def pipeline(name: str) -> str:
    """tokenizer.json contents of one pipeline."""
    from tokenizers import Regex, decoders, normalizers, pre_tokenizers

    if name == "gpt2":
        spec = _byte_level(pre_tokenizers.ByteLevel(add_prefix_space=False),
                           specials=["<|endoftext|>"])
    elif name == "llama3":
        spec = _byte_level(pre_tokenizers.Sequence([
            pre_tokenizers.Split(Regex(LLAMA3_PATTERN), "isolated"),
            pre_tokenizers.ByteLevel(add_prefix_space=False,
                                     use_regex=False)]),
            specials=LLAMA3_SPECIALS, ignore_merges=True)
    elif name == "qwen":
        spec = _byte_level(pre_tokenizers.Sequence([
            pre_tokenizers.Split(Regex(QWEN_PATTERN), "isolated"),
            pre_tokenizers.ByteLevel(add_prefix_space=False,
                                     use_regex=False)]),
            specials=["<|endoftext|>", "<|im_start|>", "<|im_end|>"],
            normalizer=normalizers.NFC())
    elif name == "llama2":
        spec = _sentencepiece(
            normalizers.Sequence([normalizers.Prepend("▁"),
                                  normalizers.Replace(" ", "▁")]),
            None,
            decoders.Sequence([decoders.Replace("▁", " "),
                               decoders.ByteFallback(), decoders.Fuse(),
                               decoders.Strip(" ", 1, 0)]))
    elif name == "mistral":
        spec = _sentencepiece(
            None, pre_tokenizers.Metaspace("▁", prepend_scheme="first",
                                           split=False),
            decoders.Sequence([decoders.Metaspace("▁",
                                                  prepend_scheme="first"),
                               decoders.ByteFallback(), decoders.Fuse()]))
    elif name == "gemma":
        spec = _sentencepiece(
            normalizers.Replace(" ", "▁"),
            pre_tokenizers.Split(" ", "merged_with_previous"),
            decoders.Sequence([decoders.Replace("▁", " "),
                               decoders.ByteFallback(), decoders.Fuse()]),
            unk="<unk>")
    else:
        raise KeyError(name)
    return json.dumps(spec)


PIPELINES = ("gpt2", "llama3", "qwen", "llama2", "mistral", "gemma")

FIXED = CORPUS_EXTRA + [
    "", " ", "  leading", "trailing  ", "\n\n", "a b", "x\x1cy",
    "<|begin_of_text|>Hi<|eot_id|> there<|end_of_text|>",
    "<s>hello</s> <unk> world", "<|im_start|>user\nhey<|im_end|>",
    "'S 'ſ 'LL 'Re", "1234567890 12 123 1234", "🎉" * 5,
    "mixed\r\n\r\nlines \n \n", "∑ ∫ ≠ ≤ →", "\U0010ffff",
]


def pair(name: str):
    text = pipeline(name)
    return (JaxHFTokenizer.from_json(text), HFTokenizer.from_json(text))


@pytest.mark.parametrize("name", PIPELINES)
def test_encode_decode_fixed(name):
    """Ids and decoded text equal `tokenizers` on the corpus and edge
    strings; vocab size and EOS discovery equal JAX's."""
    ref, port = pair(name)
    assert port.vocab_size == ref.vocab_size
    assert port.eos_token_ids == ref.eos_token_ids
    for text in FIXED + corpus()[:40]:
        ids = ref.encode(text)
        assert port.encode(text) == ids, (name, text)
        assert port.decode(ids) == ref.decode(ids), (name, text)


def _stream(tok, stream_cls, ids):
    ds = stream_cls(tok)
    out = [ds.push(t) for t in ids]
    out.append(ds.flush())
    return out


@pytest.mark.parametrize("name", PIPELINES)
@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(text=st.text(max_size=60))
def test_arbitrary_unicode(name, text):
    """Any Unicode text: encode, decode and the DecodeStream's pieces."""
    ref, port = pair(name)
    ids = ref.encode(text)
    assert port.encode(text) == ids
    assert port.decode(ids) == ref.decode(ids)
    assert (_stream(port, DecodeStream, ids)
            == _stream(ref, JaxDecodeStream, ids))


@pytest.mark.parametrize("name", PIPELINES)
@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data())
def test_arbitrary_ids_decode(name, data):
    """Any id sequence (specials, byte-fallback tokens, ids outside the
    vocabulary) decodes to the same text and stream pieces."""
    ref, port = pair(name)
    hi = ref.vocab_size + 3
    ids = data.draw(st.lists(st.integers(0, hi), max_size=24))
    assert port.decode(ids) == ref.decode(ids)
    assert (_stream(port, DecodeStream, ids)
            == _stream(ref, JaxDecodeStream, ids))


def test_special_tokens_flags():
    """lstrip / rstrip / single_word / normalized added tokens split as
    `tokenizers` splits them."""
    from tokenizers import AddedToken, Tokenizer

    spec = json.loads(pipeline("llama3"))
    base = Tokenizer.from_str(json.dumps(spec))
    base.add_special_tokens([AddedToken("<mask>", lstrip=True, rstrip=True)])
    base.add_tokens([AddedToken("word", single_word=True),
                     AddedToken("abc", normalized=True)])
    text = base.to_str()
    ref, port = JaxHFTokenizer.from_json(text), HFTokenizer.from_json(text)
    for s in ["a <mask> b", "x<mask>y", "  <mask>  ", "word words sword word.",
              "abcabc xabc", "<mask><mask>"]:
        assert port.encode(s) == ref.encode(s), s
        ids = ref.encode(s)
        assert port.decode(ids) == ref.decode(ids), s


def test_smoke_tokenizer_and_added_ids():
    """chip_smoke's Llama-3-style tokenizer.json (merges learnt from the
    repo's text, the vocabulary filled to 128000, Llama-3's specials)
    equals `tokenizers`; so does a file whose added-token ids do not
    follow its vocabulary, which `tokenizers` renumbers on load."""
    import chip_smoke

    text = chip_smoke.llama3_tokenizer_json()
    ref, port = JaxHFTokenizer.from_json(text), HFTokenizer.from_json(text)
    assert port.vocab_size == ref.vocab_size == 128011
    assert port.eos_token_ids == ref.eos_token_ids == (128009, 128001)
    sample = ("<|begin_of_text|><|start_header_id|>user<|end_header_id|>"
              "\n\n" + chip_smoke.CKPT_TURN.format(i=3) + "<|eot_id|>")
    for s in [sample] + corpus()[:30]:
        assert port.encode(s) == ref.encode(s), s
        assert port.decode(port.encode(s)) == ref.decode(ref.encode(s))
    spec = json.loads(pipeline("llama2"))
    for i, tok in enumerate(spec["added_tokens"]):
        tok["id"] = 50_000 + 7 * i            # ids the file gets wrong
    spec["added_tokens"].append(dict(spec["added_tokens"][0],
                                     content="▁the", id=3))
    text = json.dumps(spec)
    ref, port = JaxHFTokenizer.from_json(text), HFTokenizer.from_json(text)
    for s in ["<s>the</s> <unk> the", "hello"]:
        assert port.encode(s) == ref.encode(s)
    assert [port._tok.token_to_id(t["content"]) for t in spec["added_tokens"]] \
        == [ref._tok.token_to_id(t["content"]) for t in spec["added_tokens"]]


def test_eos_discovery_and_card(tmp_path):
    """`eos_token` names the EOS; the model card builds `hf_file` and
    `hf_inline` tokenizers from the same file."""
    text = pipeline("llama3")
    path = tmp_path / "tokenizer.json"
    path.write_text(text)
    ref = JaxHFTokenizer(str(path), eos_token="<|eot_id|>")
    port = HFTokenizer(str(path), eos_token="<|eot_id|>")
    assert port.eos_token_ids == ref.eos_token_ids
    for spec in ({"kind": "hf_file", "path": str(path)},
                 {"kind": "hf_inline", "json": text,
                  "eos_token": "<|eot_id|>"}):
        tok = ModelDeploymentCard(name="m", tokenizer_spec=spec) \
            .build_tokenizer()
        assert isinstance(tok, HFTokenizer)
        assert tok.encode("Hi there") == ref.encode("Hi there")
    with pytest.raises(ValueError, match="unknown tokenizer spec"):
        ModelDeploymentCard(name="m", tokenizer_spec={"kind": "nope"}) \
            .build_tokenizer()


@pytest.mark.parametrize("where,component", [
    ("model", {"type": "WordPiece", "vocab": {}}),
    ("pre_tokenizer", {"type": "Digits", "individual_digits": True}),
    ("normalizer", {"type": "BertNormalizer"}),
    ("decoder", {"type": "CTC"}),
])
def test_unknown_component_raises(where, component):
    """A component outside the interpreter raises and names itself."""
    spec = json.loads(pipeline("gpt2"))
    spec[where] = component
    with pytest.raises(tj.UnsupportedTokenizer, match=component["type"]):
        HFTokenizer.from_json(json.dumps(spec))


def test_onig_classes():
    """The rewritten classes: Unicode White_Space (not Python's \\s),
    letters and numbers by general category, the (?i:) group kept."""
    import re

    ws = re.compile(tj.onig_to_re(r"\s+"))
    assert ws.fullmatch("  　\x85")
    assert not ws.fullmatch("\x1c") and not ws.fullmatch("᠎")
    letters = re.compile(tj.onig_to_re(r"[^\r\n\p{L}\p{N}]?\p{L}+"))
    assert letters.fullmatch(" ẞtraße")
    assert re.compile(tj.onig_to_re(r"\p{N}{1,3}")).fullmatch("²③٣")
    assert re.compile(tj.onig_to_re(r"(?i:'s)")).fullmatch("'ſ")


def test_port_imports_none_of_the_reference_libraries():
    """Importing every module of the port, and chip_smoke.py, loads none
    of `safetensors`, `tokenizers`, `regex` or `transformers` (the serving
    machine has none of them), nor `jax` or the JAX package; nor does
    building a `--tp 2` worker's mesh and its tp engine on the CPU."""
    import subprocess
    import sys

    code = (
        "import importlib, pkgutil, sys\n"
        "import dynamo_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(dynamo_tpu_torch.__path__, "
        "'dynamo_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "from dynamo_tpu_torch.parallel import mesh, sharding\n"
        "from dynamo_tpu_torch.worker.main import build_mesh, parse_args\n"
        "from dynamo_tpu_torch.engine.engine import EngineConfig, EngineCore\n"
        "from dynamo_tpu_torch.models.config import get_config\n"
        "m = build_mesh(parse_args(['--control-plane', 'h:1', '--device', "
        "'cpu', '--tp', '2']))\n"
        "core = EngineCore(EngineConfig(model=get_config('tiny-test'), "
        "device='cpu', num_blocks=16, tp=m.tp))\n"
        "assert core.group.tp == 2 and len(core.params) == 2\n"
        "roots = {'safetensors', 'tokenizers', 'regex', 'transformers', "
        "'jax', 'dynamo_tpu'}\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in roots))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
