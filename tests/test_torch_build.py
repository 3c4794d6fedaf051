"""The port's native build (arbius_tpu_torch/ops/_build.py) on the CPU:
a library's name carries a hash of everything its source is built from,
so an edited source or header is rebuilt and a stale library is never
loaded. Compiling a CUDA source needs nvcc and is exercised on the card
(chip_smoke.py)."""
from __future__ import annotations

import pytest

from arbius_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    for name, text in (("k.cu", '#include "shared.cuh"\n'),
                       ("shared.cuh", "// v1\n"), ("c.cc", "int x;\n")):
        (tmp_path / name).write_text(text)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


@pytest.mark.parametrize("edited,cu_moves,cc_moves", [
    ("k.cu", True, False), ("shared.cuh", True, False),
    ("c.cc", False, True)])
def test_library_name_follows_its_source_and_the_headers(csrc, edited,
                                                         cu_moves, cc_moves):
    before = [_build.library_path(s) for s in ("k.cu", "c.cc")]
    (csrc / edited).write_text((csrc / edited).read_text() + "// edit\n")
    after = [_build.library_path(s) for s in ("k.cu", "c.cc")]
    assert [a != b for a, b in zip(after, before)] == [cu_moves, cc_moves]
    assert after[0].name.startswith("k-") and after[0].suffix == ".so"
