"""The reference's source lints over the port: detlint (determinism,
jit purity, lock discipline) and conclint (the whole-program thread and
lockset audit), both JAX-free modules of arbius_tpu/analysis, run over
arbius_tpu_torch/ against the port's own baseline,
arbius_tpu_torch/lint-baseline.json. Every finding is fixed, allowed by
a pragma with its reason, or baselined with its reason; no baseline
entry is stale; and the copied pipeline's `enforce[CONC302]` directive
still holds in the port (an unbounded stage queue fails the lint even
with a baseline): CONC302 scopes itself by path to the reference's
node package, so that check lays the port's node/ out under that path.
The copied simnet, fleet, alert-engine and fleetscope modules keep their
`enforce[DET101,...]` directives live: a copy that reads the wall clock
fails the lint, enforced."""
from __future__ import annotations

import json
import pathlib

import pytest

from arbius_tpu.analysis.baseline import Baseline
from arbius_tpu.analysis.conc import analyze_conc_tree
from arbius_tpu.analysis.core import analyze_tree, load_builtin_rules

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "arbius_tpu_torch"
BASELINE = PORT / "lint-baseline.json"


def _detlint(paths, root=REPO):
    load_builtin_rules()
    return analyze_tree([str(p) for p in paths], root=str(root))[0]


def _conclint(paths, root=REPO):
    return analyze_conc_tree([str(p) for p in paths], root=str(root))[0]


LINTS = {"detlint": _detlint, "conclint": _conclint}


@pytest.fixture(scope="module")
def findings():
    return {name: lint([PORT]) for name, lint in LINTS.items()}


@pytest.mark.parametrize("lint", list(LINTS))
def test_port_is_clean_against_its_baseline(lint, findings):
    left = Baseline.load(str(BASELINE)).apply(findings[lint])
    assert not left, "\n".join(f.text() for f in left)


def test_baseline_entries_are_live_and_reasoned(findings):
    """Each entry absorbs exactly its count of current findings (none
    stale), under the lint that owns its rule, with a written reason."""
    doc = json.loads(BASELINE.read_text())
    assert doc["version"] == 1
    every = findings["detlint"] + findings["conclint"]
    for e in doc["findings"]:
        hits = [f for f in every if (f.path, f.rule, f.snippet)
                == (e["path"], e["rule"], e["snippet"])]
        assert len(hits) == e["count"], e
        assert e["reason"] and "UNREVIEWED" not in e["reason"], e
        assert e["path"].startswith("arbius_tpu_torch/"), e


def _node_as_rule_scope(tmp_path, pipeline_src=None):
    """The port's node/ laid out as `arbius_tpu/node/` under tmp_path:
    CONC302 scopes itself by path to the reference's node package, so
    this is how it reaches the port's copies."""
    node = tmp_path / "arbius_tpu" / "node"
    node.mkdir(parents=True)
    for f in sorted((PORT / "node").glob("*.py")):
        (node / f.name).write_text(f.read_text())
    if pipeline_src is not None:
        (node / "pipeline.py").write_text(pipeline_src)
    return [f for f in _detlint([tmp_path / "arbius_tpu"], root=tmp_path)
            if f.rule == "CONC302"]


@pytest.mark.parametrize("bounded", [True, False],
                         ids=["as_shipped", "unbounded_mutant"])
def test_pipeline_conc302_stays_enforced(tmp_path, bounded):
    """Every stage queue of the port's node is bounded (CONC302, which
    the general scan above cannot apply: the rule is scoped to the
    reference's node path); a copy of the port's pipeline whose
    device->encode queue is unbounded fails it, enforced, so no baseline
    can absorb it."""
    src = (PORT / "node" / "pipeline.py").read_text()
    shape = "queue.Queue(maxsize=max(1, cfg.depth))"
    assert src.count(shape) == 1
    found = _node_as_rule_scope(
        tmp_path, None if bounded else src.replace(shape, "queue.Queue()"))
    if bounded:
        assert not found, "\n".join(f.text() for f in found)
    else:
        assert len(found) == 1 and found[0].enforced
        assert found[0].path == "arbius_tpu/node/pipeline.py"


# the copies of simnet, the fleet, the alert engine and fleetscope carry
# the reference's `detlint: enforce` directives
SIM_ENFORCED = sorted(
    p.relative_to(PORT).as_posix()
    for p in [*(PORT / "sim").glob("*.py"), *(PORT / "fleet").glob("*.py"),
              PORT / "obs" / "healthwatch.py", PORT / "obs" / "fleetscope.py"]
    if "# detlint: enforce[" in p.read_text())
WALL_CLOCK = "\n\ndef _mutant_clock():\n    import time\n\n    return time.time()\n"


@pytest.mark.parametrize("path", SIM_ENFORCED)
def test_copied_enforce_directives_hold(tmp_path, path):
    """Each copied module's `enforce[DET101,...]` holds over the port: as
    shipped it has no enforced finding, and a copy that reads the wall
    clock fails DET101 enforced, so no pragma or baseline can absorb it."""
    src = (PORT / path).read_text()
    assert "# detlint: enforce[DET101," in src
    assert not [f for f in _detlint([PORT / path]) if f.enforced]
    mutant = tmp_path / "arbius_tpu_torch" / path
    mutant.parent.mkdir(parents=True)
    mutant.write_text(src + WALL_CLOCK)
    hits = [f for f in _detlint([mutant], root=tmp_path)
            if f.rule == "DET101"]
    assert len(hits) == 1 and hits[0].enforced, hits
