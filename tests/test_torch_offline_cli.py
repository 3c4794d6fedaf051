"""The port's offline verbs (arbius_tpu_torch/cli.py `templates`,
`template`, `validate-config`, `cid`, `commitment`, `emission`): each
prints the reference's bytes for the same arguments, on stdout and
stderr, with the same exit code, a failing `validate-config` and a bad
`emission --supply` included."""
from __future__ import annotations

import json
import pathlib

import pytest

from arbius_tpu.cli import main as ref_main
from arbius_tpu_torch.cli import main as port_main

REPO = pathlib.Path(__file__).resolve().parent.parent
TEMPLATES = ("anythingv3", "damo", "kandinsky2", "robust_video_matting",
             "textgen", "zeroscopev2xl")
CONFIGS = {
    "no-template": {"models": [{"id": "0x" + "11" * 32}]},
    "bad-weights-dtype": {"models": [{"id": "0x" + "11" * 32,
                                      "template": "anythingv3",
                                      "weights_dtype": "f16"}]},
    "clip-bpe-without-vocab": {"models": [{
        "id": "0x" + "11" * 32, "template": "anythingv3",
        "tokenizer": "clip_bpe", "merges_path": "merges.txt"}]},
    "bad-tokenizer": {"models": [{"id": "0x" + "11" * 32,
                                  "template": "anythingv3",
                                  "tokenizer": "sentencepiece"}]},
}

ARGVS = [
    ["templates"],
    *(["template", name] for name in TEMPLATES),
    ["validate-config", str(REPO / "MiningConfig.example.json")],
    *(["validate-config", f"{{dir}}/{name}.json"] for name in CONFIGS),
    ["validate-config", "{dir}/not-there.json"],
    ["validate-config", "{dir}/not-json.json"],
    ["cid", str(REPO / "tests" / "fixtures" / "clip_merges.txt")],
    ["cid", "{dir}/empty.bin"],
    ["commitment", "0x" + "ab" * 20, "0x" + "cd" * 32, "0x1220" + "ee" * 32],
    ["commitment", "0x" + "01" * 20, "0x" + "02" * 32, "0x03"],
    ["emission"],
    ["emission", "--t", "0"],
    ["emission", "--t", "86400", "--supply", "0"],
    ["emission", "--t", "1000000000", "--supply", "500000.000000000000000001"],
]


@pytest.fixture
def workdir(tmp_path):
    for name, cfg in CONFIGS.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(cfg))
    (tmp_path / "not-json.json").write_text("{models: ")
    (tmp_path / "empty.bin").write_bytes(b"")
    return tmp_path


def _run(main, argv, capsys):
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = ("exit", str(e.code))
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(
    pathlib.Path(x).name if "/" in x else x for x in a))
def test_offline_verb_prints_reference_bytes(argv, workdir, capsys):
    argv = [a.format(dir=workdir) for a in argv]
    ref = _run(ref_main, argv, capsys)
    port = _run(port_main, argv, capsys)
    assert port == ref
    if argv[0] == "validate-config":
        assert ref[0] == (0 if "example" in argv[1] else 1)
        assert (ref[2].startswith("INVALID: ")) == (ref[0] == 1)


@pytest.mark.parametrize("supply", ["bad", "-1", "0.0000000000000000001"])
def test_emission_bad_supply_exits_as_reference(supply, capsys):
    argv = ["emission", "--supply", supply]
    ref = _run(ref_main, argv, capsys)
    assert ref[0][0] == "exit"
    assert _run(port_main, argv, capsys) == ref
