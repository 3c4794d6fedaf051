"""The port's ops verbs (arbius_tpu_torch/cli.py) against a served devnet,
on the CPU, with real signed transactions over HTTP JSON-RPC.

The reference's devnet scenarios (tests/test_ops_cli.py) run on the port:
that module's text, with `arbius_tpu.` read as `arbius_tpu_torch.`, is
loaded as a module of its own (tests/torch_ported.py), and each of its
tests is a case here, so every case drives the port's `main` over the
port's DevnetNode and imports nothing of the reference. Then chip_smoke.py
phase 13's script of every ops verb (`chip_smoke.ops_verb_script`) runs
through both packages' `main`s against two worlds built alike: signing is
RFC-6979, so what each verb prints, tx hashes and ids included, must be
equal byte for byte."""
from __future__ import annotations

import importlib
import pathlib

import pytest

import chip_smoke
from torch_ported import cases, renamed_module, run_case

REPO = pathlib.Path(__file__).resolve().parent.parent
PORTED = renamed_module(REPO / "tests" / "test_ops_cli.py")
world = PORTED.world        # the scenarios' fixture, on the port's devnet
CASES = cases(PORTED)


def test_the_ported_cases_import_only_the_port():
    assert len(CASES) == 18
    assert PORTED.main.__module__ == "arbius_tpu_torch.cli"
    assert PORTED.DevnetNode.__module__ == "arbius_tpu_torch.chain.devnet"


@pytest.mark.parametrize("case", CASES)
def test_reference_scenario_on_the_port(case, request):
    run_case(PORTED, case, request)


def _transcript(pkg: str, workdir: pathlib.Path) -> tuple[list[str], dict]:
    def mod(path):
        return importlib.import_module(f"{pkg}.{path}")

    workdir.mkdir()
    eng, dev, dep, operator, miner, server = chip_smoke.ops_world(
        mod("chain"), mod("chain.devnet"), str(workdir))
    try:
        lines = chip_smoke.ops_verb_script(
            mod("cli").main, mod("chain.governance"), dep, operator, miner,
            dev.governor_address)
    finally:
        server.shutdown()
        server.server_close()
    state = {"version": eng.version, "paused": eng.paused,
             "owner": eng.owner, "pauser": eng.pauser,
             "accrued": eng.accrued_fees,
             "rates": {k.hex(): m.rate for k, m in eng.models.items()},
             "tasks": sorted(k.hex() for k in eng.tasks),
             "block": eng.block_number, "now": eng.now}
    return lines, state


def test_ops_verb_script_prints_what_the_reference_prints(tmp_path):
    """Every verb of phase 13's script (register, stake, signal support,
    submit, sign offline and decode, transfer, the owner's engine-admin
    calls, retract, treasury sweep, a governance lifecycle, balances and
    task views) prints the same bytes through both CLIs, and leaves the
    same chain state."""
    ours, our_state = _transcript("arbius_tpu_torch", tmp_path / "port")
    theirs, their_state = _transcript("arbius_tpu", tmp_path / "reference")
    assert len(ours) == 30
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a == b, f"verb {i}: {a!r} != {b!r}"
    assert ours == theirs
    assert our_state == their_state
    assert our_state["version"] == 3 and our_state["accrued"] == 0
