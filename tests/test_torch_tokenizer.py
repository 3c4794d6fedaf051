"""The port's CLIP BPE tokenizer (arbius_tpu_torch/models/sd15/tokenizer.py,
a byte-equal copy of the reference's) and the factory's tokenizer choice.

Tokenizer ids are an exact layer: over the repository's CLIP fixtures
(tests/fixtures/clip_vocab.json and clip_merges.txt, which pin OpenAI's
documented ids) the port's ids equal the reference's for every prompt
here, and the reference's own CLIP BPE tests (`TestCLIPBPE` of
tests/test_sd15.py, `test_clip_bpe_documented_example_ids` of
tests/test_pinning_config.py) run on the port through
tests/torch_ported.py. A model with `tokenizer: "clip_bpe"` gets the
tokenizer, its length the text tower's, for each text family."""
from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

from arbius_tpu.models.sd15 import CLIPBPETokenizer as RefCLIPBPETokenizer
from arbius_tpu_torch.models.sd15 import CLIPBPETokenizer
from arbius_tpu_torch.node import build_registry, load_config
from torch_ported import renamed_definitions

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"
VOCAB, MERGES = FIXTURES / "clip_vocab.json", FIXTURES / "clip_merges.txt"

# the reference's CLIP BPE tests, on the port (pytest collects the class
# here, with its `tok` fixture, and each of its five tests is a case)
TestCLIPBPE = renamed_definitions(REPO / "tests" / "test_sd15.py",
                                  ("TestCLIPBPE",)).TestCLIPBPE
PINNING = renamed_definitions(
    REPO / "tests" / "test_pinning_config.py",
    ("FIXTURES", "test_clip_bpe_documented_example_ids"))

PROMPTS = [
    "a photo of a cat",
    "A Photo OF a CAT",
    "a dog, a cat; a photo... of (a) dog!?",
    "it's the cat's photo, isn't it? we'll've",
    "  a \t photo\n\nof   a  cat  ",
    "",
    "   ",
    "ünïcödé café naïve — ✓ 猫 🐱",
    "photo_of__a_cat 2024 3.14 #42 @dog",
    "a photo of a cat " * 30,              # past 77 tokens
    "x" * 300,
]


@pytest.fixture(scope="module")
def tokenizers():
    return (CLIPBPETokenizer.from_files(str(VOCAB), str(MERGES)),
            RefCLIPBPETokenizer.from_files(str(VOCAB), str(MERGES)))


def test_the_ported_tests_drive_the_port():
    assert TestCLIPBPE.__module__ == "ported_test_sd15"
    assert "arbius_tpu_torch.models.sd15" in PINNING.__dict__[
        "test_clip_bpe_documented_example_ids"].__code__.co_names


def test_clip_bpe_documented_example_ids():
    PINNING.test_clip_bpe_documented_example_ids()


@pytest.mark.parametrize("prompt", PROMPTS)
def test_ids_equal_reference(tokenizers, prompt):
    ours, ref = tokenizers
    got, want = ours.encode(prompt), ref.encode(prompt)
    assert got.dtype == want.dtype == np.int32 and got.shape == (77,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_length", [16, 77])
def test_batch_ids_equal_reference_at_max_length(tokenizers, max_length):
    ours, ref = tokenizers
    ours.max_length = ref.max_length = max_length
    try:
        got, want = ours.encode_batch(PROMPTS), ref.encode_batch(PROMPTS)
    finally:
        ours.max_length = ref.max_length = 77
    assert got.shape == (len(PROMPTS), max_length)
    np.testing.assert_array_equal(got, want)


def test_bytes_to_unicode_equal_reference():
    from arbius_tpu.models.sd15.tokenizer import _bytes_to_unicode as ref
    from arbius_tpu_torch.models.sd15.tokenizer import _bytes_to_unicode

    assert _bytes_to_unicode() == ref()
    assert len(set(ref().values())) == 256


@pytest.mark.parametrize("template", ["anythingv3", "kandinsky2", "damo"])
def test_factory_selects_clip_bpe_tokenizer(template):
    """`tokenizer: "clip_bpe"` gives the family's pipeline the CLIP BPE
    tokenizer over the configured files, its length the text tower's
    (the tiny config's here); the byte tokenizer stays the default."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = load_config({"compile_cache_dir": None, "models": [
            {"id": "0x" + "11" * 32, "template": template, "tiny": True,
             "tokenizer": "clip_bpe", "vocab_path": str(VOCAB),
             "merges_path": str(MERGES)},
            {"id": "0x" + "22" * 32, "template": template, "tiny": True}]})
        reg = build_registry(cfg, device="cpu")
    finally:
        torch.set_num_threads(threads)
    pipe = reg.get("0x" + "11" * 32).runner.pipeline
    assert isinstance(pipe.tokenizer, CLIPBPETokenizer)
    assert pipe.tokenizer.max_length == pipe.config.text.max_length
    assert pipe.tokenizer.encode("a dog")[:4].tolist() == \
        [49406, 320, 1929, 49407][:pipe.config.text.max_length]
    other = reg.get("0x" + "22" * 32).runner.pipeline.tokenizer
    assert not isinstance(other, CLIPBPETokenizer)


def test_clip_bpe_files_must_exist():
    """A clip_bpe model whose vocabulary file is missing fails at boot."""
    cfg = load_config({"compile_cache_dir": None, "models": [
        {"id": "0x" + "11" * 32, "template": "anythingv3", "tiny": True,
         "tokenizer": "clip_bpe", "vocab_path": str(VOCAB) + ".missing",
         "merges_path": str(MERGES)}]})
    with pytest.raises(FileNotFoundError):
        build_registry(cfg, device="cpu")
